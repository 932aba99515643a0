// Capped disjoint-paths matrix for Hopper (sm_90a).
//
// Computes P[s, t] = min(#internally vertex-disjoint s-t paths, cap + 1)
// for every vertex pair of one graph, the matrix that
// repro_torch.core.bounds.disjoint_paths_matrix computes on the host with
// one max-flow per pair, bit for bit.  It replaces no Pallas kernel: the
// JAX package computes this matrix on the host too
// (src/repro/core/bounds.py, disjoint_paths_matrix).
//
// The host function's network splits every vertex v into v_in -> v_out
// (capacity 1 inside, unbounded at s and t) and gives every edge uv an
// arc u_out -> v_in of capacity 1; the flow from s_out to t_in stops at
// cap + 1.  Here:
//   * an edge st is one path up front: the host network's s_out -> t_in
//     arc, which a maximum flow always saturates.  The search below never
//     uses that arc again;
//   * the rest is a flow with vertex capacity 1, so an internal vertex v
//     lies on at most one path: the flow is pred[v] and succ[v] (bytes,
//     n <= 256) for the vertices in the mask `flow`, plus the mask `tin`
//     of t's flow neighbours (s's are the vertices whose pred is s);
//   * an augmenting path is found by a layered search over the split
//     residual graph.  Every residual arc joins an in-node to an
//     out-node, so the layers alternate:
//       y_in  <- x_out over an edge xy that carries no flow x -> y
//                (x != pred[y]; for y = t, x not in tin and x != s),
//       y_in  <- y_out when y carries flow (its inner arc reversed),
//       v_out <- v_in  when v carries no flow,
//       v_out <- succ[v]_in when v carries flow (its out arc reversed);
//     the reached in- and out-sets are W-word masks, the same on every
//     lane.  The path is walked back from t_in by the parents (pred is
//     rewritten, succ read as it was) and succ rebuilt from pred;
//   * the search stops at min(cap + 1, deg s, deg t): no flow passes the
//     degrees, so when a degree is the bound the last, failing search is
//     skipped.
//
// What bounds it on this card: bytes are n*W*4 read and n*n*4 written
// (under 300 KB at n = 256), microseconds at HBM rate.  The time is
// latency: each pair runs up to cap + 1 searches of a few dependent
// layers each.
//
// Design: one warp per unordered pair, all pairs in one launch, several
// warps per block, the adjacency staged once per block in shared memory.
// Lane `lane` owns the vertices lane + 32 r (r < W): a layer is W
// ballots, each lane testing its vertices' rows against the frontier
// mask with shared-memory reads, so a layer costs O(W * W) word operations
// per lane and no global traffic.  pred, succ and the search parents are
// per-warp bytes in shared memory.  Pairs are independent and the
// warps of one block and of all blocks run their searches side by side,
// which is what hides each search's latency.  Warps past the pairs write
// the zero diagonal, so the matrix needs no memset.
#include <cstdint>
#include <cuda_runtime.h>

#include "../../common/bits.cuh"

namespace {

using rt::kFull;
using rt::kWarp;

constexpr int kMaxWords = 8;

// bit q of a W-word mask held in registers
template <int W>
__device__ __forceinline__ bool has(const uint32_t (&m)[W], int q) {
  uint32_t word = 0u;
#pragma unroll
  for (int x = 0; x < W; ++x)
    if (x == (q >> 5)) word = m[x];
  return (word >> (q & 31)) & 1u;
}

template <int W>
__device__ __forceinline__ void set_bit(uint32_t (&m)[W], int q, bool on) {
#pragma unroll
  for (int x = 0; x < W; ++x)
    if (x == (q >> 5)) {
      const uint32_t b = 1u << (q & 31);
      m[x] = on ? (m[x] | b) : (m[x] & ~b);
    }
}

template <int W>
__device__ __forceinline__ bool any_bit(const uint32_t (&m)[W]) {
  uint32_t o = 0u;
#pragma unroll
  for (int x = 0; x < W; ++x) o |= m[x];
  return o != 0u;
}

// One augmenting search from s_out to t_in over the residual graph of the
// flow (flow, tin, pred, succ).  On success, augments along the path
// found and returns true.
template <int W>
__device__ __forceinline__ bool augment(const uint32_t* __restrict__ s_adj, int n, int s,
                        int t, int lane, uint32_t (&flow)[W],
                        uint32_t (&tin)[W], uint8_t* pred, uint8_t* succ,
                        uint8_t* par) {
  uint32_t vin[W], vout[W], fin[W], fout[W], self_in[W];
#pragma unroll
  for (int x = 0; x < W; ++x) vin[x] = vout[x] = fout[x] = self_in[x] = 0u;
  set_bit<W>(vin, s, true);     // s_in leads nowhere
  set_bit<W>(vout, s, true);    // the source
  set_bit<W>(vout, t, true);    // t_out is never on a path
  set_bit<W>(fout, s, true);

  for (;;) {
    // in-nodes reached from the out-frontier
#pragma unroll
    for (int r = 0; r < W; ++r) {
      const int y = lane + kWarp * r;
      bool edge = false, self = false;
      if (y < n && !((vin[r] >> lane) & 1u)) {
        const bool fl = (flow[r] >> lane) & 1u;
        const int q = fl ? pred[y] : 0;
        int p = -1;
#pragma unroll
        for (int x = 0; x < W; ++x) {
          uint32_t ex = 0u;
          if (fl && x == (q >> 5)) ex |= 1u << (q & 31);
          if (y == t) {
            ex |= tin[x];
            if (x == (s >> 5)) ex |= 1u << (s & 31);
          }
          const uint32_t c = s_adj[y * W + x] & fout[x] & ~ex;
          if (p < 0 && c) p = kWarp * x + __ffs(c) - 1;
        }
        if (p >= 0) {
          par[y] = (uint8_t)p;
          edge = true;
        } else if (fl && ((fout[r] >> lane) & 1u)) {
          self = true;
        }
      }
      fin[r] = __ballot_sync(kFull, edge || self);
      self_in[r] |= __ballot_sync(kFull, self);
      vin[r] |= fin[r];
    }
    if (has<W>(fin, t)) break;
    if (!any_bit<W>(fin)) return false;

    // out-nodes reached from the in-frontier
#pragma unroll
    for (int r = 0; r < W; ++r) {
      const int v = lane + kWarp * r;
      bool reach = false;
      if (v < n && !((vout[r] >> lane) & 1u)) {
        reach = ((flow[r] >> lane) & 1u) ? has<W>(fin, succ[v])
                                          : ((fin[r] >> lane) & 1u);
      }
      fout[r] = __ballot_sync(kFull, reach);
      vout[r] |= fout[r];
    }
    if (!any_bit<W>(fout)) return false;
  }
  __syncwarp();                 // the parents written above

  // walk back from t_in; `inner` is true at an in-node
  uint32_t has_pred[W];
#pragma unroll
  for (int x = 0; x < W; ++x) has_pred[x] = flow[x];
  int v = t;
  bool inner = true;
  for (;;) {
    if (inner) {
      if (v != t && has<W>(self_in, v)) {     // y_out -> y_in
        inner = false;
        continue;
      }
      const int x = par[v];                   // x_out -> v_in
      if (v == t) {
        set_bit<W>(tin, x, true);
      } else {
        if (lane == 0) pred[v] = (uint8_t)x;
        set_bit<W>(has_pred, v, true);
      }
      v = x;
      inner = false;
    } else {
      if (v == s) break;
      if (has<W>(flow, v)) {                  // y_in -> v_out, y = succ[v]
        const int y = succ[v];
        set_bit<W>(has_pred, y, false);
        v = y;
      }                                       // else v_in -> v_out
      inner = true;
    }
  }
#pragma unroll
  for (int x = 0; x < W; ++x) flow[x] = has_pred[x];
  __syncwarp();                 // pred written by lane 0
#pragma unroll
  for (int r = 0; r < W; ++r) {
    const int y = lane + kWarp * r;
    if (y >= n) continue;
    if ((flow[r] >> lane) & 1u) succ[pred[y]] = (uint8_t)y;
    if ((tin[r] >> lane) & 1u) succ[y] = (uint8_t)t;
  }
  __syncwarp();
  return true;
}

template <int W>
__global__ void paths_kernel(const uint32_t* __restrict__ adj, int n,
                             int cap, int n_pairs,
                             int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const int nw = n * W;

  uint32_t* s_adj = smem;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) s_adj[i] = adj[i];
  __syncthreads();

  const int id = blockIdx.x * warps + warp;
  if (id < n && lane == 0) out[(size_t)id * n + id] = 0;
  if (id >= n_pairs) return;

  uint8_t* bytes = reinterpret_cast<uint8_t*>(smem + nw) + warp * 3 * n;
  uint8_t* pred = bytes;
  uint8_t* succ = bytes + n;
  uint8_t* par = bytes + 2 * n;

  // pair id -> (s, t), s < t, in row-major order of the upper triangle
  int s = 0, rem = id;
  while (rem >= n - 1 - s) {
    rem -= n - 1 - s;
    ++s;
  }
  const int t = s + 1 + rem;

  int deg_s = 0, deg_t = 0;
#pragma unroll
  for (int x = 0; x < W; ++x) {
    deg_s += __popc(s_adj[s * W + x]);
    deg_t += __popc(s_adj[t * W + x]);
  }
  const int target = max(0, min(cap + 1, min(deg_s, deg_t)));
  int count = (s_adj[s * W + (t >> 5)] >> (t & 31)) & 1u;

  uint32_t flow[W], tin[W];
#pragma unroll
  for (int x = 0; x < W; ++x) flow[x] = tin[x] = 0u;
  while (count < target &&
         augment<W>(s_adj, n, s, t, lane, flow, tin, pred, succ, par))
    ++count;
  if (lane == 0) {
    const int32_t value = min(count, target);
    out[(size_t)s * n + t] = value;
    out[(size_t)t * n + s] = value;
  }
}

template <int W>
cudaError_t launch(const void* adj, int n, int cap, int warps_per_block,
                   void* out, cudaStream_t stream) {
  const int n_pairs = n * (n - 1) / 2;
  const int warps = n_pairs > n ? n_pairs : n;
  const int blocks = (warps + warps_per_block - 1) / warps_per_block;
  const size_t smem = (size_t)n * W * sizeof(uint32_t)
                      + (size_t)warps_per_block * 3 * n;
  paths_kernel<W><<<blocks, warps_per_block * kWarp, smem, stream>>>(
      static_cast<const uint32_t*>(adj), n, cap, n_pairs,
      static_cast<int32_t*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" int paths_max_words() { return kMaxWords; }

// Writes the whole (n, n) int32 matrix `out`.  Returns a cudaError_t: 0
// on a clean launch.
extern "C" int paths_launch(const void* adj, int n, int w, int cap,
                            int warps_per_block, void* out, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_CASE(WW) \
  case WW:          \
    return launch<WW>(adj, n, cap, warps_per_block, out, st);
  switch (w) {
    RT_CASE(1) RT_CASE(2) RT_CASE(3) RT_CASE(4)
    RT_CASE(5) RT_CASE(6) RT_CASE(7) RT_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef RT_CASE
}
