// Fused wavefront expansion for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wavefront/kernel.py
// (_wavefront_kernel, launched by wavefront_pallas) together with its
// bodies src/repro/kernels/expand/kernel.py (reach_block),
// src/repro/kernels/mmw/kernel.py (mmw_block) and the bit helpers of
// src/repro/kernels/common.py.  For every state row S (W words) over the
// packed adjacency adj (n rows of W words) it computes:
//
//   z   = closure of the components of G[S] (rows of S only)
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
// in practice launch latency and the length of each warp's dependent chain
// set its time.
//
// Lanes: one launch serves every lane of a multi-lane dispatch (the
// reference gets this axis from pallas_call's batching rule under vmap).
// Each lane has its own adjacency, states, valid rows, allowed mask, k and
// outputs, all B rows deep; the grid's y dimension is the lane, so a block
// loads only its own lane's adjacency and its shared memory does not grow
// with the lane count.  k comes from a device array per lane (no host
// read), or as a plain argument for a single lane.
//
// Design: one warp per state, WARPS_PER_BLOCK states per block, the
// adjacency in shared memory once per block.  Each lane keeps its W rows
// of z, nb and reach in registers (rt::reach_rows in
// ../../common/bits.cuh): the closure is Warshall's, one warp-uniform step
// per vertex of S, with row j broadcast by __shfl_sync, and nb and reach
// are uniform loops over S as well, so no lane waits on another's
// popcount.  A row that is not valid writes its children and a zero
// feasibility row and skips the rest.  The pruning rules run only for
// rows that still have a feasible candidate.  MMW contracts a copy of
// reach in registers (rt::mmw_warp); only the simplicial rule, which
// reads witness rows at random, needs shared memory per warp: reach is
// copied into the warp's n*W words.  Feasibility is a W-bit register
// mask per lane.  Children are written row-major with consecutive lanes
// on consecutive words.
#include <cstdint>
#include <cuda_runtime.h>

#include "../../common/bits.cuh"

namespace {

using rt::kWarp;

template <int W, bool MMW, bool SIMP>
__global__ void wavefront_kernel(const uint32_t* __restrict__ adj,
                                 const uint32_t* __restrict__ states,
                                 size_t states_lane_stride,
                                 const uint8_t* __restrict__ valid,
                                 const uint32_t* __restrict__ allowed,
                                 int k, const int* __restrict__ k_lanes,
                                 int n, int n_states,
                                 uint32_t* __restrict__ children,
                                 uint8_t* __restrict__ feasible) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const int nw = n * W;

  // the dispatch lane of this block (blockIdx.y): its own adjacency,
  // states, k and outputs
  const size_t l = blockIdx.y;
  adj += l * nw;
  states += l * states_lane_stride;
  valid += l * n_states;
  allowed += l * W;
  children += l * n_states * nw;
  feasible += l * n_states * n;
  if (k_lanes != nullptr) k = k_lanes[l];

  uint32_t* s_adj = smem;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) s_adj[i] = adj[i];
  __syncthreads();

  const int row = blockIdx.x * warps + warp;
  if (row >= n_states) return;

  uint32_t s[W];
#pragma unroll
  for (int x = 0; x < W; ++x) s[x] = states[(size_t)row * W + x];

  uint32_t feas = 0u;        // bit r: row v = lane + 32 r is feasible
  if (valid[row] != 0) {     // the same on every lane of the warp
    rt::Rows<W> reach;
    int deg[W];
    rt::reach_rows<W>(s_adj, s, n, lane, reach, deg);
#pragma unroll
    for (int r = 0; r < W; ++r) {
      const int v = lane + kWarp * r;
      const bool out_s = !((s[r] >> lane) & 1u);
      const bool ok = (allowed[r] >> lane) & 1u;
      if (v < n && deg[r] <= k && out_s && ok) feas |= 1u << r;
    }
    // the rules change nothing in a row without a feasible candidate
    if ((MMW || SIMP) && __any_sync(rt::kFull, feas != 0u)) {
      if (SIMP) {
        uint32_t* rbuf = smem + nw + warp * nw;
#pragma unroll
        for (int r = 0; r < W; ++r) {
          const int v = lane + kWarp * r;
          if (v < n) {
#pragma unroll
            for (int x = 0; x < W; ++x) rbuf[v * W + x] = reach.v[r][x];
          }
        }
        __syncwarp();
        feas = rt::simplicial_collapse<W>(rbuf, s, n, lane, feas);
      }
      if (MMW && rt::mmw_warp<W>(reach, s, n, k, lane) > k) feas = 0u;
    }
  }

#pragma unroll
  for (int r = 0; r < W; ++r) {
    const int v = lane + kWarp * r;
    if (v < n) feasible[(size_t)row * n + v] = (feas >> r) & 1u;
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

// The launch arguments every instantiation shares.
struct Args {
  const void* adj;
  const void* states;
  size_t states_lane_stride;   // words from one lane's states to the next
  const void* valid;
  const void* allowed;
  int k;
  const int* k_lanes;          // (lanes,) per-lane k on the device, or null
  int n, n_states, lanes, warps_per_block;
  void* children;
  void* feasible;
  cudaStream_t stream;
};

template <int W, bool MMW, bool SIMP>
cudaError_t launch(const Args& a) {
  // at most 40 KB (n = 256, W = 8, the simplicial rule, 4 warps), under
  // the 48 KB a launch may take without cudaFuncSetAttribute; a launch
  // that asks for more is refused and reported
  const size_t per_warp = SIMP ? (size_t)a.n * W : 0;
  const size_t smem =
      sizeof(uint32_t) * ((size_t)a.n * W + per_warp * a.warps_per_block);
  const dim3 grid((a.n_states + a.warps_per_block - 1) / a.warps_per_block,
                  a.lanes);
  wavefront_kernel<W, MMW, SIMP>
      <<<grid, a.warps_per_block * kWarp, smem, a.stream>>>(
          static_cast<const uint32_t*>(a.adj),
          static_cast<const uint32_t*>(a.states), a.states_lane_stride,
          static_cast<const uint8_t*>(a.valid),
          static_cast<const uint32_t*>(a.allowed), a.k, a.k_lanes, a.n,
          a.n_states, static_cast<uint32_t*>(a.children),
          static_cast<uint8_t*>(a.feasible));
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_flags(bool mmw, bool simp, const Args& a) {
  if (mmw && simp) return launch<W, true, true>(a);
  if (mmw) return launch<W, true, false>(a);
  if (simp) return launch<W, false, true>(a);
  return launch<W, false, false>(a);
}

}  // namespace

extern "C" int wavefront_max_words() { return 8; }

// One launch expands n_states rows of every one of `lanes` lanes: lane l
// reads adj + l*n*w, states + l*states_lane_stride, valid + l*n_states,
// allowed + l*w and k_lanes[l] (or k when k_lanes is null) and writes
// children + l*n_states*n*w and feasible + l*n_states*n.  Returns a
// cudaError_t: 0 on a clean launch.
extern "C" int wavefront_launch(const void* adj, const void* states,
                                size_t states_lane_stride, const void* valid,
                                const void* allowed, int k,
                                const void* k_lanes, int n, int w,
                                int n_states, int lanes,
                                int warps_per_block, int use_mmw,
                                int use_simplicial, void* children,
                                void* feasible, void* stream) {
  if (n_states <= 0 || lanes <= 0) return cudaSuccess;
  if (lanes > 65535) return cudaErrorInvalidValue;     // gridDim.y
  const Args a{adj, states, states_lane_stride, valid, allowed, k,
               static_cast<const int*>(k_lanes), n, n_states, lanes,
               warps_per_block, children, feasible,
               static_cast<cudaStream_t>(stream)};
  const bool mmw = use_mmw != 0, simp = use_simplicial != 0;
#define RT_CASE(WW) \
  case WW:          \
    return launch_flags<WW>(mmw, simp, a);
  switch (w) {
    RT_CASE(1) RT_CASE(2) RT_CASE(3) RT_CASE(4)
    RT_CASE(5) RT_CASE(6) RT_CASE(7) RT_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef RT_CASE
}
