// Fused wavefront expansion for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wavefront/kernel.py
// (_wavefront_kernel, launched by wavefront_pallas) together with its body
// src/repro/kernels/expand/kernel.py (reach_block) and the bit helpers of
// src/repro/kernels/common.py.  For every state row S (W words) over the
// packed adjacency adj (n rows of W words) it computes:
//
//   z   = (adj & S) | I on the rows i in S, 0 elsewhere
//   z  |= z.z   ceil(log2 max(n,2)) times (OR-AND semiring): closure of G[S]
//   nb  = z.adj                     neighbourhood of i's S-component
//   reach[v] = adj[v] | OR_{i in adj[v] & S} nb[i]
//   deg[v]   = popcount(reach[v] & ~S & ~{v})
//   feasible[row, v] = deg <= k & v not in S & allowed[v] & valid[row]
//   children[row, v] = S | {v}     for every v
//
// Pruning rules (MMW, simplicial collapse) are not part of this kernel yet.
//
// What bounds it on this card: its least time is set by bytes, mostly the
// outputs (children is B*n*W words and feasible B*n bytes, against B*W
// words of input); the closure is a few hundred word operations per state
// on data that stays on chip.  At the solver's shapes (B = 2048, n <= 64,
// W <= 2) a call moves under a megabyte, about 0.2-0.3 us at 3.35 TB/s, so
// in practice launch latency and each lane's serial walk over set bits
// set its time (about 0.05 ms on an H100 SXM at 700 W).
//
// Design: one warp per state, several states per block.  The adjacency is
// loaded into shared memory once per block.  Each warp keeps its state's
// z and a second buffer (the doubling target, then nb) in dynamic shared
// memory: 2*n*W words per state.  Lanes stride over the rows; each row's
// OR-AND product walks the set bits of its mask with __ffs.  The closure
// is double-buffered, so every step reads the previous step's rows, as the
// reference does.  reach is computed one row per lane in registers and
// never written to device memory.  Children are written row-major with
// consecutive lanes on consecutive words.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;

template <int W>
__device__ __forceinline__ void or_rows_of(const uint32_t* __restrict__ mask,
                                           const uint32_t* __restrict__ rows,
                                           uint32_t* acc) {
  // acc |= OR_{j in mask} rows[j]
#pragma unroll
  for (int x = 0; x < W; ++x) {
    uint32_t m = mask[x];
    while (m) {
      const int j = x * 32 + __ffs(m) - 1;
      m &= m - 1;
#pragma unroll
      for (int y = 0; y < W; ++y) acc[y] |= rows[j * W + y];
    }
  }
}

template <int W>
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
#pragma unroll
  for (int x = 0; x < W; ++x) s[x] = states[(size_t)row * W + x];

  // z0: rows of S hold (adj & S) | {i}; other rows are empty
  for (int i = lane; i < n; i += kWarp) {
    const bool in_s = (s[i >> 5] >> (i & 31)) & 1u;
#pragma unroll
    for (int x = 0; x < W; ++x) {
      uint32_t v = s_adj[i * W + x] & s[x];
      if (x == (i >> 5)) v |= 1u << (i & 31);
      zbuf[i * W + x] = in_s ? v : 0u;
    }
  }
  __syncwarp();

  // doubling: z |= z.z, double-buffered
  for (int t = 0; t < steps; ++t) {
    for (int i = lane; i < n; i += kWarp) {
      uint32_t acc[W];
#pragma unroll
      for (int x = 0; x < W; ++x) acc[x] = zbuf[i * W + x];
      or_rows_of<W>(zbuf + i * W, zbuf, acc);
#pragma unroll
      for (int x = 0; x < W; ++x) tbuf[i * W + x] = acc[x];
    }
    __syncwarp();
    uint32_t* tmp = zbuf;
    zbuf = tbuf;
    tbuf = tmp;
  }

  // nb = z.adj  (into the spare buffer)
  for (int i = lane; i < n; i += kWarp) {
    uint32_t acc[W];
#pragma unroll
    for (int x = 0; x < W; ++x) acc[x] = 0u;
    or_rows_of<W>(zbuf + i * W, s_adj, acc);
#pragma unroll
    for (int x = 0; x < W; ++x) tbuf[i * W + x] = acc[x];
  }
  __syncwarp();
  const uint32_t* nb = tbuf;

  const bool row_valid = valid[row] != 0;
  for (int v = lane; v < n; v += kWarp) {
    uint32_t reach[W];
    uint32_t hop[W];
#pragma unroll
    for (int x = 0; x < W; ++x) {
      reach[x] = s_adj[v * W + x];
      hop[x] = reach[x] & s[x];
    }
    or_rows_of<W>(hop, nb, reach);
    int deg = 0;
#pragma unroll
    for (int x = 0; x < W; ++x) {
      uint32_t q = reach[x] & ~s[x];
      if (x == (v >> 5)) q &= ~(1u << (v & 31));
      deg += __popc(q);
    }
    const uint32_t bit = 1u << (v & 31);
    const bool in_s = (s[v >> 5] & bit) != 0;
    const bool ok = (allowed[v >> 5] & bit) != 0;
    feasible[(size_t)row * n + v] =
        (deg <= k && !in_s && ok && row_valid) ? 1 : 0;
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

template <int W>
cudaError_t launch(const void* adj, const void* states, const void* valid,
                   const void* allowed, int k, int n, int n_states,
                   int steps, int warps_per_block, void* children,
                   void* feasible, cudaStream_t stream) {
  const size_t smem =
      sizeof(uint32_t) * (size_t)n * W * (1 + 2 * (size_t)warps_per_block);
  cudaError_t err = cudaFuncSetAttribute(
      wavefront_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_states + warps_per_block - 1) / warps_per_block;
  wavefront_kernel<W><<<blocks, warps_per_block * kWarp, smem, stream>>>(
      static_cast<const uint32_t*>(adj), static_cast<const uint32_t*>(states),
      static_cast<const uint8_t*>(valid),
      static_cast<const uint32_t*>(allowed), k, n, n_states, steps,
      static_cast<uint32_t*>(children), static_cast<uint8_t*>(feasible));
  return cudaGetLastError();
}

}  // namespace

extern "C" int wavefront_max_words() { return 8; }

// Returns a cudaError_t: 0 on a clean launch.
extern "C" int wavefront_launch(const void* adj, const void* states,
                                const void* valid, const void* allowed, int k,
                                int n, int w, int n_states, int steps,
                                int warps_per_block, void* children,
                                void* feasible, void* stream) {
  if (n_states <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 1: return launch<1>(adj, states, valid, allowed, k, n, n_states, steps, warps_per_block, children, feasible, st);
    case 2: return launch<2>(adj, states, valid, allowed, k, n, n_states, steps, warps_per_block, children, feasible, st);
    case 3: return launch<3>(adj, states, valid, allowed, k, n, n_states, steps, warps_per_block, children, feasible, st);
    case 4: return launch<4>(adj, states, valid, allowed, k, n, n_states, steps, warps_per_block, children, feasible, st);
    case 5: return launch<5>(adj, states, valid, allowed, k, n, n_states, steps, warps_per_block, children, feasible, st);
    case 6: return launch<6>(adj, states, valid, allowed, k, n, n_states, steps, warps_per_block, children, feasible, st);
    case 7: return launch<7>(adj, states, valid, allowed, k, n, n_states, steps, warps_per_block, children, feasible, st);
    case 8: return launch<8>(adj, states, valid, allowed, k, n, n_states, steps, warps_per_block, children, feasible, st);
    default: return cudaErrorInvalidValue;
  }
}
