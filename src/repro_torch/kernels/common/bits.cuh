// Per-state bitset routines shared by the port's Hopper kernels.
//
// Device code included by wavefront.cu (B1), mmw.cu (B4) and expand.cu
// (B6).  It ports the factored Pallas bodies
// src/repro/kernels/expand/kernel.py (reach_block) and
// src/repro/kernels/mmw/kernel.py (mmw_block), and the simplicial rule of
// src/repro/core/expand.py (simplicial_viol, collapse_simplicial).
//
// Layout: a set over n vertices is W 32-bit words (bit i in word i >> 5).
// One warp works on one state.  Lane `lane` owns the rows
// v = lane + 32 * r for r < W (n <= 32 * W): row v is bit `lane` of word
// r, so a lane finds its own rows' bits at compile-time word indices, and
// per-row results fit in a W-bit register mask.
//
// reach_rows keeps the lane's W rows of W words in registers (a
// `Rows<W>`) and grows the components of G[S] by loops that are the same
// on all 32 lanes: each step reads one adjacency row that every lane
// loads at the same shared-memory address, without a branch.  The MMW
// contraction keeps its graph in registers the same way, broadcasting
// rows by __shfl_sync.  The simplicial rule reads rows at random, one
// witness per lane, so the wavefront kernel copies reach into shared
// memory for it.
#pragma once

#include <cstdint>

namespace rt {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// degree of an inactive vertex in the MMW loop (repro.core.mmw.BIG)
constexpr unsigned kBig = 1u << 20;

// The lane's rows: v[r][x] is word x of row lane + 32 r.
template <int W>
struct Rows {
  uint32_t v[W][W];
};

// All ones if bit b of word is set, else 0.
__device__ __forceinline__ uint32_t bit_mask(uint32_t word, int b) {
  return 0u - ((word >> b) & 1u);
}

// Word x of the set {0, ..., n-1}.
__device__ __forceinline__ uint32_t below(int n, int x) {
  const int rem = n - 32 * x;
  return rem >= 32 ? kFull : (rem > 0 ? (1u << rem) - 1u : 0u);
}

// Eliminated-graph rows of the lane's vertices under the state s:
//   C        ranges over the components of G[S]
//   N(C)     = OR_{j in C} adj[j]            the neighbourhood of C
//   reach[v] = adj[v] | OR_{C : adj[v] meets C} N(C)
// Only vertices below n count as members of S.  This is the reference's
//   z = closure of (adj & S) | I on the rows of S,
//   nb[i] = OR_{j in z[i]} adj[j],  reach[v] = adj[v] | OR_{i in adj[v] & S} nb[i]
// bit for bit: z[i] is i's component C, so nb[i] = N(C), and adj[v] & S
// holds a member of C exactly when adj[v] meets C (adj is an undirected
// graph's, so symmetric).  Each component is grown from its lowest
// unassigned member: the loop pops one member j at a time, ORs adj[j] into
// N (one shared-memory load per word, at one address for the whole warp)
// and queues the members of S in N that C lacks.  So each member of S costs
// one step and each component one more, in which every lane ORs N into its
// rows that meet C; all of it is warp-uniform, with no shuffle.  `s_adj`
// is the adjacency (n rows) in shared memory.  Returns reach in `reach`
// and deg_S(v) = |reach[v] \ S \ {v}| in `deg`.
template <int W>
__device__ __forceinline__ void reach_rows(const uint32_t* __restrict__ s_adj,
                                           const uint32_t (&s)[W], int n,
                                           int lane, Rows<W>& reach,
                                           int (&deg)[W]) {
  uint32_t sn[W], left[W];                  // S below n; not yet in a C
#pragma unroll
  for (int x = 0; x < W; ++x) left[x] = sn[x] = s[x] & below(n, x);

  Rows<W> a;                                // the lane's rows of adj
#pragma unroll
  for (int r = 0; r < W; ++r) {
    const int v = lane + kWarp * r;
#pragma unroll
    for (int x = 0; x < W; ++x) {
      a.v[r][x] = v < n ? s_adj[v * W + x] : 0u;
      reach.v[r][x] = a.v[r][x];
    }
  }

  for (;;) {
    uint32_t comp[W], todo[W], nbr[W];
    bool seeded = false;                    // todo = lowest member of left
#pragma unroll
    for (int x = 0; x < W; ++x) {
      comp[x] = nbr[x] = 0u;
      todo[x] = seeded ? 0u : left[x] & (0u - left[x]);
      seeded |= left[x] != 0u;
    }
    if (!seeded) break;
    for (;;) {
      uint32_t low[W];                      // pop the lowest queued member
      bool found = false;
      int j = 0;
#pragma unroll
      for (int x = 0; x < W; ++x) {
        low[x] = found ? 0u : todo[x] & (0u - todo[x]);
        if (low[x]) j = kWarp * x + __ffs(low[x]) - 1;
        found |= todo[x] != 0u;
      }
      if (!found) break;
#pragma unroll
      for (int x = 0; x < W; ++x) {
        comp[x] |= low[x];
        nbr[x] |= s_adj[j * W + x];
      }
#pragma unroll
      for (int x = 0; x < W; ++x) todo[x] = nbr[x] & sn[x] & ~comp[x];
    }
#pragma unroll
    for (int x = 0; x < W; ++x) left[x] &= ~comp[x];
#pragma unroll
    for (int r = 0; r < W; ++r) {
      uint32_t hit = 0u;
#pragma unroll
      for (int x = 0; x < W; ++x) hit |= a.v[r][x] & comp[x];
      const uint32_t sel = hit ? kFull : 0u;
#pragma unroll
      for (int y = 0; y < W; ++y) reach.v[r][y] |= sel & nbr[y];
    }
  }

#pragma unroll
  for (int r = 0; r < W; ++r) {
    int d = 0;
#pragma unroll
    for (int y = 0; y < W; ++y) {
      uint32_t q = reach.v[r][y] & ~s[y];
      if (y == r) q &= ~(1u << lane);
      d += __popc(q);
    }
    deg[r] = d;
  }
}

// Simplicial collapse (repro.core.expand.simplicial_mask and
// collapse_simplicial).  `rbuf` holds reach (n rows); `feas` is this
// lane's feasibility mask (bit r for row lane + 32 r).  A feasible v is
// simplicial when no witness u in Q_v = reach[v] \ S \ {v} has a closed
// neighbourhood reach[u] | {u} that misses part of Q_v.  If the state has
// a simplicial candidate, only the lowest-index one stays feasible
// (jnp.argmax's first True).  Returns the lane's new mask.
template <int W>
__device__ __forceinline__ uint32_t simplicial_collapse(
    const uint32_t* __restrict__ rbuf, const uint32_t (&s)[W], int n,
    int lane, uint32_t feas) {
  unsigned first = kFull;
#pragma unroll
  for (int r = 0; r < W; ++r) {
    const int v = lane + kWarp * r;
    if (v >= n || !((feas >> r) & 1u)) continue;
    uint32_t q[W];
#pragma unroll
    for (int x = 0; x < W; ++x) {
      q[x] = rbuf[v * W + x] & ~s[x];
      if (x == (v >> 5)) q[x] &= ~(1u << (v & 31));
    }
    bool viol = false;
#pragma unroll
    for (int x = 0; x < W; ++x) {
      uint32_t m = q[x];
      while (m && !viol) {
        const int u = x * 32 + __ffs(m) - 1;
        m &= m - 1;
        uint32_t miss = 0u;
#pragma unroll
        for (int y = 0; y < W; ++y) {
          uint32_t closed = rbuf[u * W + y];
          if (y == (u >> 5)) closed |= 1u << (u & 31);
          miss |= q[y] & ~closed;
        }
        viol = miss != 0u;
      }
    }
    if (!viol && first == kFull) first = (unsigned)v;
  }
  const unsigned idx = __reduce_min_sync(kFull, first);
  if (idx == kFull) return feas;
  return ((int)(idx & 31u) == lane) ? (1u << (idx >> 5)) : 0u;
}

// Row v of a warp's Rows, on every lane: the owner lane is v & 31 and the
// slot v >> 5 (the same on all lanes, picked by a compile-time loop).
template <int W>
__device__ __forceinline__ void broadcast_row(const Rows<W>& a, int v,
                                              uint32_t (&out)[W]) {
#pragma unroll
  for (int x = 0; x < W; ++x) {
    uint32_t word = 0u;
#pragma unroll
    for (int r = 0; r < W; ++r)
      if (r == (v >> 5)) word = a.v[r][x];
    out[x] = __shfl_sync(kFull, word, v & 31);
  }
}

// Minor-min-width lower bound of one state (repro.core.mmw.mmw_bound),
// run by the whole warp on the lane's rows of reach (registers).  The
// contracted graph stays in registers too, one row per lane and slot as
// reach; rows v and u of a step are broadcast by __shfl_sync.  Each step
// contracts the minimum-degree active vertex v into its minimum-degree
// neighbour u (v itself when isolated); ties go to the lowest index, as
// jnp.argmin's, by taking the warp minimum of (degree << 8) | index
// (n <= 256).  The loop stops once the bound exceeds k or at most one
// vertex is active: the returned lb is then the reference's.
//
// STOP_AT_K (the wavefront kernel, which needs only whether lb > k) also
// stops once nact - 1 <= k.  Proof that this changes no answer: a step
// with nact active vertices lifts lb to at most its second-smallest
// active degree, and every degree in the contracted graph is at most
// nact - 1 (a row holds only other active vertices).  nact falls by one
// per step, so once a step begins with nact - 1 <= k and lb <= k, every
// later step lifts lb to at most k, and the final lb is <= k.  The
// returned lb may then be below the reference's; both are <= k.
//
// It is not inlined: inlined into the wavefront kernel, the loop ran a
// third slower on the card (H100, n = 36 and 49).
template <int W, bool STOP_AT_K = false>
__device__ __noinline__ int mmw_warp(const Rows<W>& reach,
                                     const uint32_t (&s)[W], int n, int k,
                                     int lane) {
  uint32_t active[W];
  int nact = 0;
#pragma unroll
  for (int x = 0; x < W; ++x) {
    active[x] = below(n, x) & ~s[x];
    nact += __popc(active[x]);
  }
  Rows<W> a;                         // the contracted graph
#pragma unroll
  for (int r = 0; r < W; ++r) {
    const uint32_t act = bit_mask(active[r], lane);   // 0 for i >= n
#pragma unroll
    for (int x = 0; x < W; ++x) {
      uint32_t v = reach.v[r][x] & active[x];
      if (x == r) v &= ~(1u << lane);
      a.v[r][x] = v & act;
    }
  }

  int lb = 0;
  while (nact > 1 && lb <= k && (!STOP_AT_K || nact > k + 1)) {
    unsigned key[W];
    unsigned best = kFull;
#pragma unroll
    for (int r = 0; r < W; ++r) {
      const int i = lane + kWarp * r;
      key[r] = kFull;
      if (i >= n) continue;
      unsigned d = kBig;
      if ((active[r] >> lane) & 1u) {
        d = 0;
#pragma unroll
        for (int x = 0; x < W; ++x) d += __popc(a.v[r][x]);
      }
      key[r] = (d << 8) | (unsigned)i;
      best = min(best, key[r]);
    }
    const unsigned vkey = __reduce_min_sync(kFull, best);
    const int v = (int)(vkey & 255u);
    const unsigned dv = vkey >> 8;
    unsigned second = kFull;
#pragma unroll
    for (int r = 0; r < W; ++r)
      if (key[r] != vkey) second = min(second, key[r]);
    second = __reduce_min_sync(kFull, second) >> 8;
    lb = max(lb, (int)min(second, kBig - 1));

    uint32_t vrow[W];
    broadcast_row<W>(a, v, vrow);
    int u = v;
    if (dv > 0) {
      unsigned bestn = kFull;
#pragma unroll
      for (int r = 0; r < W; ++r) {
        const int i = lane + kWarp * r;
        if (i >= n) continue;
        const unsigned dn = (vrow[r] >> lane) & 1u ? (key[r] >> 8) : kBig;
        bestn = min(bestn, (dn << 8) | (unsigned)i);
      }
      u = (int)(__reduce_min_sync(kFull, bestn) & 255u);
    }
    uint32_t um[W], vm[W];                 // columns u and v
#pragma unroll
    for (int x = 0; x < W; ++x) {
      um[x] = x == (u >> 5) ? 1u << (u & 31) : 0u;
      vm[x] = x == (v >> 5) ? 1u << (v & 31) : 0u;
    }
    uint32_t merged[W];
    broadcast_row<W>(a, u, merged);
#pragma unroll
    for (int x = 0; x < W; ++x)
      merged[x] = (merged[x] | vrow[x]) & active[x] & ~(um[x] | vm[x]);
    // every row: clear column u, set column v to its bit of merged; then
    // row v becomes merged and row u empty
#pragma unroll
    for (int r = 0; r < W; ++r) {
      const int i = lane + kWarp * r;
      const uint32_t in_v = bit_mask(merged[r], lane);
      const uint32_t is_v = i == v ? kFull : 0u;
      const uint32_t keep = i == u ? 0u : kFull;
#pragma unroll
      for (int x = 0; x < W; ++x) {
        const uint32_t row =
            (a.v[r][x] & ~(um[x] | vm[x])) | (in_v & vm[x]);
        a.v[r][x] = ((row & ~is_v) | (merged[x] & is_v)) & keep;
      }
    }
#pragma unroll
    for (int x = 0; x < W; ++x) active[x] &= ~um[x];
    --nact;
  }
  return lb;
}

}  // namespace rt
