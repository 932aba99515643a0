// Minor-min-width lower bounds for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mmw/kernel.py (_mmw_kernel,
// body mmw_block, launched by mmw_bounds_pallas): for every state row S
// and its eliminated-graph rows reach (n rows of W words) it writes the
// minor-min-width bound of repro.core.mmw.mmw_bound, frozen once it
// exceeds k.  The contraction loop is rt::mmw_warp (../../common/bits.cuh),
// the same device function the fused wavefront kernel runs under use_mmw.
//
// What bounds it on this card: the input, B*n*W words of reach, is read
// once; each state then needs up to n-1 dependent contraction steps of
// O(n*W) word operations and two or three warp-wide reductions.  At the
// solver's shapes the byte bound is a fraction of a microsecond and the
// steps' latency (not their operations) sets the time.
//
// Design: one warp per state, several states per block.  The Pallas
// kernel runs a static n-1 steps with done-masks; here each warp leaves
// its loop as soon as its own bound exceeds k or one vertex is left.  Each
// lane reads its rows of the state's reach (rows lane + 32 r) once from
// device memory into registers, and the contraction runs there, rows v
// and u of each step broadcast by __shfl_sync; no shared memory.  Argmins
// are warp minima of (degree << 8) | index, which break ties to the
// lowest index as jnp.argmin does.
#include <cstdint>
#include <cuda_runtime.h>

#include "../../common/bits.cuh"

namespace {

using rt::kWarp;

template <int W>
__global__ void mmw_kernel(const uint32_t* __restrict__ reach,
                           const uint32_t* __restrict__ states, int k, int n,
                           int n_states, int32_t* __restrict__ lb_out) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const int row = blockIdx.x * warps + warp;
  if (row >= n_states) return;
  const uint32_t* mine = reach + (size_t)row * n * W;
  uint32_t s[W];
  rt::Rows<W> rows;
#pragma unroll
  for (int x = 0; x < W; ++x) s[x] = states[(size_t)row * W + x];
#pragma unroll
  for (int r = 0; r < W; ++r) {
    const int i = lane + kWarp * r;
#pragma unroll
    for (int x = 0; x < W; ++x) rows.v[r][x] = i < n ? mine[i * W + x] : 0u;
  }
  const int lb = rt::mmw_warp<W>(rows, s, n, k, lane);
  if (lane == 0) lb_out[row] = lb;
}

template <int W>
cudaError_t launch(const void* reach, const void* states, int k, int n,
                   int n_states, int warps_per_block, void* lb,
                   cudaStream_t stream) {
  const int blocks = (n_states + warps_per_block - 1) / warps_per_block;
  mmw_kernel<W><<<blocks, warps_per_block * kWarp, 0, stream>>>(
      static_cast<const uint32_t*>(reach),
      static_cast<const uint32_t*>(states), k, n, n_states,
      static_cast<int32_t*>(lb));
  return cudaGetLastError();
}

}  // namespace

extern "C" int mmw_max_words() { return 8; }

// Returns a cudaError_t: 0 on a clean launch.
extern "C" int mmw_launch(const void* reach, const void* states, int k,
                          int n, int w, int n_states, int warps_per_block,
                          void* lb, void* stream) {
  if (n_states <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_CASE(WW)                                                        \
  case WW:                                                                 \
    return launch<WW>(reach, states, k, n, n_states, warps_per_block, lb,  \
                      st);
  switch (w) {
    RT_CASE(1) RT_CASE(2) RT_CASE(3) RT_CASE(4)
    RT_CASE(5) RT_CASE(6) RT_CASE(7) RT_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef RT_CASE
}
