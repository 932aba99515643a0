// Fused wavefront expansion for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wavefront/kernel.py
// (_wavefront_kernel, launched by wavefront_pallas) together with its
// bodies src/repro/kernels/expand/kernel.py (reach_block),
// src/repro/kernels/mmw/kernel.py (mmw_block) and the bit helpers of
// src/repro/kernels/common.py.  For every state row S (W words) over the
// packed adjacency adj (n rows of W words) it computes:
//
//   z   = (adj & S) | I on the rows i in S, 0 elsewhere
//   z  |= z.z   ceil(log2 max(n,2)) times (OR-AND semiring): closure of G[S]
//   nb  = z.adj                     neighbourhood of i's S-component
//   reach[v] = adj[v] | OR_{i in adj[v] & S} nb[i]
//   deg[v]   = popcount(reach[v] & ~S & ~{v})
//   feasible[row, v] = deg <= k & v not in S & allowed[v] & valid[row]
//   SIMP: if the row has a feasible simplicial v, only the lowest stays
//   MMW:  feasible[row, :] &= mmw_bound(reach, S) <= k
//   children[row, v] = S | {v}     for every v
//
// What bounds it on this card: its least time is set by bytes, mostly the
// outputs (children is B*n*W words and feasible B*n bytes, against B*W
// words of input); the closure is a few hundred word operations per state
// on data that stays on chip.  At the solver's shapes (B = 2048, n <= 64,
// W <= 2) a call moves under a megabyte, about 0.2-0.3 us at 3.35 TB/s, so
// in practice launch latency and each lane's serial walk over set bits
// set its time.  The MMW prune adds up to n-1 dependent contraction steps
// per state, each two or three warp-wide min reductions; it runs only for
// rows that still have a feasible candidate.
//
// Design: one warp per state, several states per block.  The adjacency is
// loaded into shared memory once per block.  Each warp keeps its state's
// z and a second buffer (the doubling target, then nb) in dynamic shared
// memory: 2*n*W words per state.  Lanes stride over the rows; each row's
// OR-AND product walks the set bits of its mask with __ffs.  The closure
// is double-buffered, so every step reads the previous step's rows, as the
// reference does.  Without pruning, reach stays one row per lane in
// registers.  With a pruning rule, reach is written into the z buffer
// (dead once nb exists) and MMW contracts its copy in the nb buffer (dead
// once reach exists), so shared memory stays 2*n*W words per warp.
// Feasibility is a W-bit register mask per lane.  Children are written
// row-major with consecutive lanes on consecutive words.
#include <cstdint>
#include <cuda_runtime.h>

#include "../../common/bits.cuh"

namespace {

using rt::kWarp;

template <int W, bool MMW, bool SIMP>
__global__ void wavefront_kernel(const uint32_t* __restrict__ adj,
                                 const uint32_t* __restrict__ states,
                                 const uint8_t* __restrict__ valid,
                                 const uint32_t* __restrict__ allowed,
                                 int k, int n, int n_states, int steps,
                                 uint32_t* __restrict__ children,
                                 uint8_t* __restrict__ feasible) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const int nw = n * W;

  uint32_t* s_adj = smem;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) s_adj[i] = adj[i];
  __syncthreads();

  const int row = blockIdx.x * warps + warp;
  if (row >= n_states) return;

  uint32_t* zbuf = smem + nw + warp * 2 * nw;
  uint32_t* tbuf = zbuf + nw;

  uint32_t s[W];
  uint32_t ok_v[W];
#pragma unroll
  for (int x = 0; x < W; ++x) {
    s[x] = states[(size_t)row * W + x];
    ok_v[x] = allowed[x];
  }

  rt::closure_nb<W>(s_adj, s, n, steps, lane, zbuf, tbuf);
  const uint32_t* nb = tbuf;

  const bool row_valid = valid[row] != 0;
  uint32_t feas = 0u;        // bit r: row v = lane + 32 r is feasible
#pragma unroll
  for (int r = 0; r < W; ++r) {
    const int v = lane + kWarp * r;
    if (v >= n) break;
    uint32_t reach[W];
    const int deg = rt::reach_row<W>(s_adj, nb, s, v, reach);
    if (MMW || SIMP) {
#pragma unroll
      for (int x = 0; x < W; ++x) zbuf[v * W + x] = reach[x];
    }
    if (deg <= k && !rt::has_bit<W>(s, v) && rt::has_bit<W>(ok_v, v) &&
        row_valid)
      feas |= 1u << r;
  }
  if (MMW || SIMP) __syncwarp();

  if (SIMP) feas = rt::simplicial_collapse<W>(zbuf, s, n, lane, feas);
  if (MMW) {
    // the bound of a row without feasible candidates is never read
    if (__any_sync(rt::kFull, feas != 0u)) {
      const int lb = rt::mmw_warp<W>(zbuf, tbuf, s, n, k, lane);
      if (lb > k) feas = 0u;
    }
  }

#pragma unroll
  for (int r = 0; r < W; ++r) {
    const int v = lane + kWarp * r;
    if (v >= n) break;
    feasible[(size_t)row * n + v] = (feas >> r) & 1u;
  }

  uint32_t* out = children + (size_t)row * nw;
  for (int idx = lane; idx < nw; idx += kWarp) {
    const int v = idx / W;
    const int x = idx - v * W;
    uint32_t word = s[x];
    if (x == (v >> 5)) word |= 1u << (v & 31);
    out[idx] = word;
  }
}

template <int W, bool MMW, bool SIMP>
cudaError_t launch(const void* adj, const void* states, const void* valid,
                   const void* allowed, int k, int n, int n_states,
                   int steps, int warps_per_block, void* children,
                   void* feasible, cudaStream_t stream) {
  const size_t smem =
      sizeof(uint32_t) * (size_t)n * W * (1 + 2 * (size_t)warps_per_block);
  cudaError_t err = cudaFuncSetAttribute(
      wavefront_kernel<W, MMW, SIMP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_states + warps_per_block - 1) / warps_per_block;
  wavefront_kernel<W, MMW, SIMP>
      <<<blocks, warps_per_block * kWarp, smem, stream>>>(
          static_cast<const uint32_t*>(adj),
          static_cast<const uint32_t*>(states),
          static_cast<const uint8_t*>(valid),
          static_cast<const uint32_t*>(allowed), k, n, n_states, steps,
          static_cast<uint32_t*>(children), static_cast<uint8_t*>(feasible));
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_flags(bool mmw, bool simp, const void* adj,
                         const void* states, const void* valid,
                         const void* allowed, int k, int n, int n_states,
                         int steps, int warps_per_block, void* children,
                         void* feasible, cudaStream_t stream) {
  if (mmw && simp)
    return launch<W, true, true>(adj, states, valid, allowed, k, n, n_states,
                                 steps, warps_per_block, children, feasible,
                                 stream);
  if (mmw)
    return launch<W, true, false>(adj, states, valid, allowed, k, n,
                                  n_states, steps, warps_per_block, children,
                                  feasible, stream);
  if (simp)
    return launch<W, false, true>(adj, states, valid, allowed, k, n,
                                  n_states, steps, warps_per_block, children,
                                  feasible, stream);
  return launch<W, false, false>(adj, states, valid, allowed, k, n, n_states,
                                 steps, warps_per_block, children, feasible,
                                 stream);
}

}  // namespace

extern "C" int wavefront_max_words() { return 8; }

// Returns a cudaError_t: 0 on a clean launch.
extern "C" int wavefront_launch(const void* adj, const void* states,
                                const void* valid, const void* allowed, int k,
                                int n, int w, int n_states, int steps,
                                int warps_per_block, int use_mmw,
                                int use_simplicial, void* children,
                                void* feasible, void* stream) {
  if (n_states <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool mmw = use_mmw != 0, simp = use_simplicial != 0;
#define RT_CASE(WW)                                                         \
  case WW:                                                                  \
    return launch_flags<WW>(mmw, simp, adj, states, valid, allowed, k, n,   \
                            n_states, steps, warps_per_block, children,     \
                            feasible, st);
  switch (w) {
    RT_CASE(1) RT_CASE(2) RT_CASE(3) RT_CASE(4)
    RT_CASE(5) RT_CASE(6) RT_CASE(7) RT_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef RT_CASE
}
