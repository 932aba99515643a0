// Fused wavefront expansion for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wavefront/kernel.py
// (_wavefront_kernel, launched by wavefront_pallas) together with its
// bodies src/repro/kernels/expand/kernel.py (reach_block),
// src/repro/kernels/mmw/kernel.py (mmw_block) and the bit helpers of
// src/repro/kernels/common.py, and its lane form, the same kernel under
// vmap (src/repro/core/batch.py, src/repro/core/shard.py).  For every
// state row S (W words) over the packed adjacency adj (n rows of W
// words) it computes:
//
//   reach[v] = adj[v] | OR of N(C) over the components C of G[S] that
//              adj[v] meets, N(C) the neighbourhood of C
//   deg[v]   = popcount(reach[v] & ~S & ~{v})
//   feasible[row, v] = deg <= k & v not in S & allowed[v] & valid[row]
//   SIMP: if the row has a feasible simplicial v, only the lowest stays
//   MMW:  feasible[row, :] &= mmw_bound(reach, S) <= k
//   children[row, v] = S | {v}     for every v
//
// Lanes: one launch serves every lane of a multi-lane dispatch.  Each lane
// has its own adjacency, states (rows contiguous, lanes
// `states_lane_stride` words apart), valid rows, allowed mask, k (from a
// device array, so no host read) and outputs, all B rows deep.
//
// What bounds it on this card: bytes, nearly all of them the outputs
// (children is B*n*W words and feasible B*n bytes, against B*W words of
// input).  At the lane paths' shape (8 lanes of 2048 states, n = 49, W =
// 2) that is 7.4 MB, 2.2 us at 3.35 TB/s; one lane of 2048 states, 0.2-0.3
// us.  Neither design comes near it.  Timed in parts on an H100 at 8
// lanes (chip_smoke.py --parts: (a) the stores alone, with no valid row;
// (b) the closure, degrees and rules alone, their result folded into one
// word; (c) the whole), the design before this one (a block of 4 warps
// per 4 states, grid (B/4, L), 32 registers, 64 warps per SM) took (a)
// 6.2, (b) 10.5 and (c) 13.3 us, with MMW (b) 39.3 of (c) 42.0 us; this
// one takes (a) 4.9, (b) 10.2 and (c) 12.1 us, with MMW 33.5 of 35.2 us.
// So the time is the warps' work, not waiting: the closure's loops over S
// and, under MMW, the contraction's dependent steps (three warp
// reductions and two row broadcasts each).  The stores alone, even as
// 16-byte stores after one round trip, take twice their bound.
//
// Design:
//  * The closure (rt::reach_rows) grows each component of G[S] from its
//    lowest member, one adjacency row per member of S read at one
//    shared-memory address by the whole warp, then merges N(C) into the
//    lane's rows that meet C, instead of Warshall's pivots followed by
//    the nb and reach products (the expand kernel, which runs only this,
//    went from 2.9 to 2.6 us at one lane of 2048 states).
//  * MMW stops once nact - 1 <= k (rt::mmw_warp<W, true>; the proof is
//    there): at the lane paths' shape nact is 44-45 and k 23..30, so a
//    state that passes takes at most 13-21 steps, not up to 44; at one
//    lane (queen6_6, k = 25) the rule cuts B1 with MMW from 17.3 to 6.0
//    us.
//  * A grid sized from the work: tiles of T = 8 * spw states of one lane
//    (spw states per warp, from the work: 1 until the resident warps are
//    all busy, up to 4), and min(tiles, blocks per SM * SMs) blocks, each
//    walking a contiguous, lane-major run of tiles, so that its lane's
//    adjacency, k and allowed mask stay in shared memory until the lane
//    changes.  The SM count and the blocks per SM are read once per
//    device (cudaDeviceGetAttribute,
//    cudaOccupancyMaxActiveBlocksPerMultiprocessor).  A block's first
//    tile loads its adjacency and states together (one round trip, not
//    the two of a load, a barrier and a load); each later tile's states,
//    valid rows and k are loaded into registers before the current
//    tile's work, so that round trip hides behind it.  At 8 lanes of 2048
//    states every block takes one tile of 32 states: four states per
//    warp in one tile ran faster than blocks walking four one-state
//    tiles with the prefetch.
//  * A warp settles its states in turn: each lane keeps its W rows of
//    reach in registers; the rules run only for rows that still have a
//    feasible candidate; MMW contracts a copy of reach in registers; only
//    the simplicial rule, which reads witness rows at random, copies
//    reach into its warp's n*W words of shared memory.  Feasibility goes
//    to a byte row per state in shared memory.
//  * The tile's outputs are contiguous: T*n*W words of children, which
//    depend only on the states (children[row, v] = S | {v}), and T*n
//    bytes of feasibility.  After one barrier the whole block writes both
//    ranges in order with 16-byte stores (scalar stores only for the
//    unaligned head and tail).  A row that is not valid gets its children
//    and a zero feasibility row.
//  * At W = 2 the kernel holds 64 registers a thread, so 32 warps per SM,
//    half the design before: the simplicial rule's random shared-memory
//    reads then hide less latency, and B1 with it alone runs 5-11% slower
//    than before (PERF.md).
#include <cstdint>
#include <cuda_runtime.h>

#include "../../common/bits.cuh"

namespace {

using rt::kWarp;

constexpr int kWarps = 8;                 // warps per block
constexpr int kThreads = kWarps * kWarp;
constexpr int kMaxSpw = 4;                // states per warp in one tile
constexpr int kMaxTile = kWarps * kMaxSpw;
constexpr int kMaxDevices = 64;

struct Params {
  const uint32_t* adj;
  const uint32_t* states;
  size_t states_lane_stride;   // words from one lane's states to the next
  const uint8_t* valid;
  const uint32_t* allowed;
  int k;
  const int* k_lanes;          // (lanes,) per-lane k on the device, or null
  int n, n_states, spw, tiles_per_lane, tiles;
  uint32_t* children;
  uint8_t* feasible;
};

// Shared memory of one block, in bytes: the adjacency, two buffers of
// tile states and valid bytes, the tile's feasibility rows (16 bytes of
// slack to match the destination's alignment) and, for the simplicial
// rule, n*W words per warp.
__host__ __device__ constexpr int align16(int b) { return (b + 15) & ~15; }
struct Layout {
  int adj, states, valid, feas, simp, total;
};
__host__ __device__ inline Layout layout(int n, int w, int tile, bool simp) {
  Layout l;
  l.adj = 0;
  l.states = align16(l.adj + 4 * n * w);
  l.valid = align16(l.states + 2 * 4 * tile * w);
  l.feas = align16(l.valid + 2 * tile);
  l.simp = align16(l.feas + tile * n + 16);
  l.total = l.simp + (simp ? 4 * kWarps * n * w : 0);
  return l;
}

// Blocks per SM that each W must fit: 64 registers a thread at W <= 2,
// with no spill (capped at 40 or 32 it spilled, and ran slower at 8
// lanes); the wide states of larger W take what they need.
template <int W>
constexpr int min_blocks() {
  return W <= 2 ? 4 : W <= 4 ? 2 : 1;
}

// One tile's loads, held in registers from issue to commit: a word of the
// states (thread i < T*W), a valid byte (thread i < T) and the lane's k.
struct Prefetch {
  uint32_t word;
  uint8_t valid;
  int k;
};

struct Tile {
  int lane, row0, rows;
};

__device__ __forceinline__ Tile tile_at(const Params& p, int t) {
  Tile tl;
  tl.lane = t / p.tiles_per_lane;
  tl.row0 = (t - tl.lane * p.tiles_per_lane) * (kWarps * p.spw);
  tl.rows = min(kWarps * p.spw, p.n_states - tl.row0);
  return tl;
}

template <int W>
__device__ __forceinline__ Prefetch issue(const Params& p, const Tile& tl) {
  Prefetch f{0u, 0, 0};
  const int i = threadIdx.x;
  if (i < tl.rows * W)
    f.word = p.states[tl.lane * p.states_lane_stride + (size_t)tl.row0 * W +
                      i];
  if (i < tl.rows) f.valid = p.valid[(size_t)tl.lane * p.n_states + tl.row0 + i];
  f.k = p.k_lanes != nullptr ? p.k_lanes[tl.lane] : p.k;
  return f;
}

// Writes a tile's prefetched loads into buffer `buf`; on a new lane also
// that lane's adjacency, allowed mask and k (read only after the barrier
// that follows).  The adjacency's loads go out before the prefetched
// words are waited for, so a block's first tile costs one round trip.
template <int W>
__device__ __forceinline__ void commit(const Params& p, const Tile& tl,
                                       const Prefetch& f, bool new_lane,
                                       unsigned char* smem, const Layout& L,
                                       int buf, int tile, uint32_t* s_allowed,
                                       int* s_k) {
  constexpr int kAdjRegs = (32 * W * W + kThreads - 1) / kThreads;
  const int i = threadIdx.x, nw = p.n * W;
  uint32_t a[kAdjRegs], allowed = 0u;
  if (new_lane) {
    const uint32_t* adj = p.adj + (size_t)tl.lane * nw;
#pragma unroll
    for (int c = 0; c < kAdjRegs; ++c) {
      const int j = i + c * kThreads;
      a[c] = j < nw ? adj[j] : 0u;
    }
    if (i < W) allowed = p.allowed[(size_t)tl.lane * W + i];
  }
  uint32_t* s_states = reinterpret_cast<uint32_t*>(smem + L.states) +
                       buf * tile * W;
  uint8_t* s_valid = smem + L.valid + buf * tile;
  if (i < tl.rows * W) s_states[i] = f.word;
  if (i < tl.rows) s_valid[i] = f.valid;
  if (new_lane) {
    uint32_t* s_adj = reinterpret_cast<uint32_t*>(smem + L.adj);
#pragma unroll
    for (int c = 0; c < kAdjRegs; ++c) {
      const int j = i + c * kThreads;
      if (j < nw) s_adj[j] = a[c];
    }
    if (i < W) s_allowed[i] = allowed;
    if (i == 0) *s_k = f.k;
  }
}

// Word r of row q of a tile's children: the state's word x = r % W,
// with bit v = r / W set in its word.
template <int W>
__device__ __forceinline__ uint32_t child_word(const uint32_t* s_states,
                                               int q, int r) {
  const int v = r / W, x = r - v * W;
  uint32_t w = s_states[q * W + x];
  if (x == (v >> 5)) w |= 1u << (v & 31);
  return w;
}

// Writes a tile's `count` = rows * n * W words of children to out: an
// unaligned head and tail word by word, the rest 16 bytes a thread.  Each
// thread's 16-byte groups lie 4 * kThreads words apart, so it steps its
// (row, offset in the row) by that much with no division in the loop.
template <int W>
__device__ __forceinline__ void store_children(const uint32_t* s_states,
                                               uint32_t* out, int count,
                                               int n) {
  const int i = threadIdx.x, nw = n * W;
  const int head = min(count, (int)((16 - (reinterpret_cast<uintptr_t>(out) &
                                           15)) & 15) / 4);
  const int vecs = (count - head) / 4;
  for (int p = i; p < head; p += kThreads)
    out[p] = child_word<W>(s_states, p / nw, p % nw);
  const int dq = 4 * kThreads / nw, dr = 4 * kThreads - dq * nw;
  int q = (head + 4 * i) / nw, r = head + 4 * i - q * nw;
  uint4* out4 = reinterpret_cast<uint4*>(out + head);
  for (int j = i; j < vecs; j += kThreads) {
    uint32_t w[4];
    int qq = q, rr = r;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      w[e] = child_word<W>(s_states, qq, rr);
      if (++rr == nw) {
        rr = 0;
        ++qq;
      }
    }
    out4[j] = make_uint4(w[0], w[1], w[2], w[3]);
    q += dq;
    r += dr;
    if (r >= nw) {
      r -= nw;
      ++q;
    }
  }
  for (int p = head + 4 * vecs + i; p < count; p += kThreads)
    out[p] = child_word<W>(s_states, p / nw, p % nw);
}

// Copies `count` bytes staged at s_feas (which has the alignment of `out`
// modulo 16) to out, 16 bytes at a time between an unaligned head and
// tail.
__device__ __forceinline__ void store_bytes(const uint8_t* s_feas,
                                            uint8_t* out, int count) {
  const int i = threadIdx.x;
  const int head =
      min(count, (int)((16 - (reinterpret_cast<uintptr_t>(out) & 15)) & 15));
  const int vecs = (count - head) / 16;
  for (int p = i; p < head; p += kThreads) out[p] = s_feas[p];
  const uint4* src = reinterpret_cast<const uint4*>(s_feas + head);
  uint4* dst = reinterpret_cast<uint4*>(out + head);
  for (int j = i; j < vecs; j += kThreads) dst[j] = src[j];
  for (int p = head + 16 * vecs + i; p < count; p += kThreads)
    out[p] = s_feas[p];
}

template <int W, bool MMW, bool SIMP>
__global__ void __launch_bounds__(kThreads, min_blocks<W>())
    wavefront_kernel(const Params p) {
  extern __shared__ uint4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  __shared__ uint32_t s_allowed[W];
  __shared__ int s_k;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int n = p.n, nw = n * W;
  const int tile = kWarps * p.spw;
  const Layout L = layout(n, W, tile, SIMP);
  const uint32_t* s_adj = reinterpret_cast<const uint32_t*>(smem + L.adj);

  // this block's run of tiles [t0, t1), lane-major
  const int per = p.tiles / gridDim.x, extra = p.tiles % gridDim.x;
  const int t0 = blockIdx.x * per + min((int)blockIdx.x, extra);
  const int t1 = t0 + per + ((int)blockIdx.x < extra ? 1 : 0);
  if (t0 >= t1) return;

  Tile cur = tile_at(p, t0);
  commit<W>(p, cur, issue<W>(p, cur), true, smem, L, 0, tile, s_allowed,
            &s_k);
  __syncthreads();

  for (int t = t0, buf = 0; t < t1; ++t, buf ^= 1) {
    // the next tile's loads go out before this tile's work
    const bool more = t + 1 < t1;
    Tile nxt{};
    Prefetch pf{0u, 0, 0};
    if (more) {
      nxt = tile_at(p, t + 1);
      pf = issue<W>(p, nxt);
    }

    const uint32_t* s_states =
        reinterpret_cast<const uint32_t*>(smem + L.states) + buf * tile * W;
    const uint8_t* s_valid = smem + L.valid + buf * tile;
    uint8_t* feas_out =
        p.feasible + ((size_t)cur.lane * p.n_states + cur.row0) * n;
    // staged at the destination's alignment modulo 16
    uint8_t* s_feas =
        smem + L.feas + (reinterpret_cast<uintptr_t>(feas_out) & 15);
    const int k = s_k;
    for (int q = warp; q < cur.rows; q += kWarps) {
      uint32_t s[W];
#pragma unroll
      for (int x = 0; x < W; ++x) s[x] = s_states[q * W + x];
      uint32_t feas = 0u;    // bit r: row v = lane + 32 r is feasible
      if (s_valid[q] != 0) {   // the same on every lane of the warp
        rt::Rows<W> reach;
        int deg[W];
        rt::reach_rows<W>(s_adj, s, n, lane, reach, deg);
#pragma unroll
        for (int r = 0; r < W; ++r) {
          const int v = lane + kWarp * r;
          const bool out_s = !((s[r] >> lane) & 1u);
          const bool ok = (s_allowed[r] >> lane) & 1u;
          if (v < n && deg[r] <= k && out_s && ok) feas |= 1u << r;
        }
        // the rules change nothing in a row without a feasible candidate
        if ((MMW || SIMP) && __any_sync(rt::kFull, feas != 0u)) {
          if (SIMP) {
            uint32_t* rbuf =
                reinterpret_cast<uint32_t*>(smem + L.simp) + warp * nw;
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
            __syncwarp();
          }
          if (MMW) {
            int in_s = 0;
#pragma unroll
            for (int x = 0; x < W; ++x) in_s += __popc(s[x] & rt::below(n, x));
            // nact - 1 <= k: the bound cannot pass k (rt::mmw_warp)
            if (n - in_s > k + 1 &&
                rt::mmw_warp<W, true>(reach, s, n, k, lane) > k)
              feas = 0u;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < W; ++r) {
        const int v = lane + kWarp * r;
        if (v < n) s_feas[q * n + v] = (feas >> r) & 1u;
      }
    }
    __syncthreads();

    store_children<W>(s_states,
                      p.children + ((size_t)cur.lane * p.n_states + cur.row0) *
                                       nw,
                      cur.rows * nw, n);
    store_bytes(s_feas, feas_out, cur.rows * n);
    if (more) {
      commit<W>(p, nxt, pf, nxt.lane != cur.lane, smem, L, buf ^ 1, tile,
                s_allowed, &s_k);
      cur = nxt;
    }
    __syncthreads();
  }
}

// Per device and instantiation: SMs, resident blocks per SM at the
// instantiation's largest shared memory (n = 32 W, full tiles), read once.
struct Occupancy {
  int sms, blocks;
};
Occupancy g_occ[kMaxDevices][8][2][2];

template <int W, bool MMW, bool SIMP>
cudaError_t occupancy(Occupancy* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Occupancy& o = g_occ[dev][W - 1][MMW][SIMP];
  if (o.blocks == 0) {
    const int most = layout(32 * W, W, kMaxTile, SIMP).total;
    auto kernel = wavefront_kernel<W, MMW, SIMP>;
    // above 48 KB a launch must ask; a refusal is reported
    if (most > 48 * 1024) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (err != cudaSuccess) return err;
    }
    int sms = 0, blocks = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, most);
    if (err != cudaSuccess) return err;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    o.sms = sms;
    o.blocks = blocks;
  }
  *out = o;
  return cudaSuccess;
}

struct Launch {
  const void* adj;
  const void* states;
  size_t states_lane_stride;
  const void* valid;
  const void* allowed;
  int k;
  const int* k_lanes;
  int n, n_states, lanes;
  void* children;
  void* feasible;
  cudaStream_t stream;
};

template <int W, bool MMW, bool SIMP>
cudaError_t launch(const Launch& a) {
  Occupancy o;
  cudaError_t err = occupancy<W, MMW, SIMP>(&o);
  if (err != cudaSuccess) return err;
  const long long slots = (long long)o.sms * o.blocks;
  const long long total = (long long)a.n_states * a.lanes;
  // states per warp: 1 until the resident warps are all busy
  const long long want = (total + slots * kWarps - 1) / (slots * kWarps);
  const int spw = (int)(want < 1 ? 1 : want > kMaxSpw ? kMaxSpw : want);
  const int tile = kWarps * spw;
  const long long per_lane = (a.n_states + tile - 1) / tile;
  const long long tiles = per_lane * a.lanes;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = layout(a.n, W, tile, SIMP).total;
  Params p{static_cast<const uint32_t*>(a.adj),
           static_cast<const uint32_t*>(a.states),
           a.states_lane_stride,
           static_cast<const uint8_t*>(a.valid),
           static_cast<const uint32_t*>(a.allowed),
           a.k,
           a.k_lanes,
           a.n,
           a.n_states,
           spw,
           (int)per_lane,
           (int)tiles,
           static_cast<uint32_t*>(a.children),
           static_cast<uint8_t*>(a.feasible)};
  const int grid = (int)(tiles < slots ? tiles : slots);
  wavefront_kernel<W, MMW, SIMP><<<grid, kThreads, smem, a.stream>>>(p);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_flags(bool mmw, bool simp, const Launch& a) {
  if (mmw && simp) return launch<W, true, true>(a);
  if (mmw) return launch<W, true, false>(a);
  if (simp) return launch<W, false, true>(a);
  return launch<W, false, false>(a);
}

template <int W>
cudaError_t occupancy_flags(bool mmw, bool simp, Occupancy* o) {
  if (mmw && simp) return occupancy<W, true, true>(o);
  if (mmw) return occupancy<W, true, false>(o);
  if (simp) return occupancy<W, false, true>(o);
  return occupancy<W, false, false>(o);
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
                                int n_states, int lanes, int use_mmw,
                                int use_simplicial, void* children,
                                void* feasible, void* stream) {
  if (n_states <= 0 || lanes <= 0) return cudaSuccess;
  if (n <= 0 || n > 32 * w) return cudaErrorInvalidValue;
  const Launch a{adj, states, states_lane_stride, valid, allowed, k,
                 static_cast<const int*>(k_lanes), n, n_states, lanes,
                 children, feasible, static_cast<cudaStream_t>(stream)};
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

// The current device's SM count, and the blocks of `threads` threads per
// SM that the instantiation for (w, use_mmw, use_simplicial) keeps
// resident at its largest shared memory.  Returns a cudaError_t.
extern "C" int wavefront_occupancy(int w, int use_mmw, int use_simplicial,
                                   int* sms, int* blocks_per_sm,
                                   int* threads) {
  Occupancy o{0, 0};
  cudaError_t err;
  const bool mmw = use_mmw != 0, simp = use_simplicial != 0;
  switch (w) {
#define RT_CASE(WW)                             \
  case WW:                                      \
    err = occupancy_flags<WW>(mmw, simp, &o);   \
    break;
    RT_CASE(1) RT_CASE(2) RT_CASE(3) RT_CASE(4)
    RT_CASE(5) RT_CASE(6) RT_CASE(7) RT_CASE(8)
#undef RT_CASE
    default: return cudaErrorInvalidValue;
  }
  *sms = o.sms;
  *blocks_per_sm = o.blocks;
  *threads = kThreads;
  return err;
}
