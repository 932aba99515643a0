// Eliminated degrees deg_S(v) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/expand/kernel.py
// (_expand_kernel, launched by expand_degrees_pallas): for every state row
// S and vertex v it writes deg_S(v) = |reach[v] \ S \ {v}|, with reach the
// eliminated-graph row of v (see ../../common/bits.cuh).  Every row gets
// its degrees, padding rows included, as the JAX op does; values for v in
// S follow the same formula and are meaningless to callers.
//
// What bounds it on this card: bytes, mostly the (B, n) int32 output
// against B*W words of input; the closure is a few hundred word
// operations per state on chip.  In practice launch latency and the
// length of each warp's dependent chain set its time.
//
// Design: the wavefront kernel's closure without its outputs: one warp per
// state, the adjacency in shared memory once per block, and each lane's
// rows of reach in registers, built by warp-uniform loops that grow the
// components of G[S] member by member (rt::reach_rows).  Degrees are
// written with consecutive lanes on consecutive v.
#include <cstdint>
#include <cuda_runtime.h>

#include "../../common/bits.cuh"

namespace {

using rt::kWarp;

template <int W>
__global__ void expand_kernel(const uint32_t* __restrict__ adj,
                              const uint32_t* __restrict__ states, int n,
                              int n_states, int32_t* __restrict__ deg_out) {
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

  uint32_t s[W];
#pragma unroll
  for (int x = 0; x < W; ++x) s[x] = states[(size_t)row * W + x];
  rt::Rows<W> reach;
  int deg[W];
  rt::reach_rows<W>(s_adj, s, n, lane, reach, deg);
#pragma unroll
  for (int r = 0; r < W; ++r) {
    const int v = lane + kWarp * r;
    if (v < n) deg_out[(size_t)row * n + v] = deg[r];
  }
}

template <int W>
cudaError_t launch(const void* adj, const void* states, int n, int n_states,
                   int warps_per_block, void* deg, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * (size_t)n * W;   // <= 8 KB
  const int blocks = (n_states + warps_per_block - 1) / warps_per_block;
  expand_kernel<W><<<blocks, warps_per_block * kWarp, smem, stream>>>(
      static_cast<const uint32_t*>(adj), static_cast<const uint32_t*>(states),
      n, n_states, static_cast<int32_t*>(deg));
  return cudaGetLastError();
}

}  // namespace

extern "C" int expand_max_words() { return 8; }

// Returns a cudaError_t: 0 on a clean launch.
extern "C" int expand_launch(const void* adj, const void* states, int n,
                             int w, int n_states, int warps_per_block,
                             void* deg, void* stream) {
  if (n_states <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_CASE(WW)                                                        \
  case WW:                                                                 \
    return launch<WW>(adj, states, n, n_states, warps_per_block, deg, st);
  switch (w) {
    RT_CASE(1) RT_CASE(2) RT_CASE(3) RT_CASE(4)
    RT_CASE(5) RT_CASE(6) RT_CASE(7) RT_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef RT_CASE
}
