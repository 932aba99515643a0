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
// v = lane + 32 * r for r < W (n <= 32 * W), so per-row results fit in a
// W-bit register mask.  Per-state matrices (n rows of W words) live in the
// warp's slice of dynamic shared memory.
#pragma once

#include <cstdint>

namespace rt {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// degree of an inactive vertex in the MMW loop (repro.core.mmw.BIG)
constexpr unsigned kBig = 1u << 20;

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

// Bit i of a register bitset.  Words are picked by a compile-time loop,
// so the array stays in registers (a run-time index would put it in local
// memory).
template <int W>
__device__ __forceinline__ bool has_bit(const uint32_t (&s)[W], int i) {
  uint32_t word = 0u;
#pragma unroll
  for (int x = 0; x < W; ++x)
    if (x == (i >> 5)) word = s[x];
  return (word >> (i & 31)) & 1u;
}

template <int W>
__device__ __forceinline__ void set_bit(uint32_t (&s)[W], int i, bool on) {
#pragma unroll
  for (int x = 0; x < W; ++x)
    if (x == (i >> 5)) {
      if (on) s[x] |= 1u << (i & 31);
      else s[x] &= ~(1u << (i & 31));
    }
}

// Component closure of G[S] and the neighbourhood of each component:
//   z  = (adj & S) | I on the rows i in S, 0 elsewhere
//   z |= z.z   `steps` times (OR-AND semiring), double-buffered
//   nb = z.adj
// On return `zbuf` holds z and `tbuf` holds nb (the pointers are swapped
// as the doubling goes).  Ends with __syncwarp().
template <int W>
__device__ void closure_nb(const uint32_t* __restrict__ s_adj,
                           const uint32_t (&s)[W], int n, int steps,
                           int lane, uint32_t*& zbuf, uint32_t*& tbuf) {
  for (int i = lane; i < n; i += kWarp) {
    const bool in_s = has_bit<W>(s, i);
#pragma unroll
    for (int x = 0; x < W; ++x) {
      uint32_t v = s_adj[i * W + x] & s[x];
      if (x == (i >> 5)) v |= 1u << (i & 31);
      zbuf[i * W + x] = in_s ? v : 0u;
    }
  }
  __syncwarp();
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
  for (int i = lane; i < n; i += kWarp) {
    uint32_t acc[W];
#pragma unroll
    for (int x = 0; x < W; ++x) acc[x] = 0u;
    or_rows_of<W>(zbuf + i * W, s_adj, acc);
#pragma unroll
    for (int x = 0; x < W; ++x) tbuf[i * W + x] = acc[x];
  }
  __syncwarp();
}

// reach[v] = adj[v] | OR_{i in adj[v] & S} nb[i]; returns
// deg_S(v) = |reach[v] \ S \ {v}|.
template <int W>
__device__ __forceinline__ int reach_row(const uint32_t* __restrict__ s_adj,
                                         const uint32_t* __restrict__ nb,
                                         const uint32_t (&s)[W], int v,
                                         uint32_t (&reach)[W]) {
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
  return deg;
}

// Simplicial collapse (repro.core.expand.simplicial_mask and
// collapse_simplicial).  `rbuf` holds reach (n rows); `feas` is this
// lane's feasibility mask (bit r for row lane + 32 r).  A feasible v is
// simplicial when no witness u in Q_v = reach[v] \ S \ {v} has a closed
// neighbourhood reach[u] | {u} that misses part of Q_v.  If the state has
// a simplicial candidate, only the lowest-index one stays feasible
// (jnp.argmax's first True).  Returns the lane's new mask.
template <int W>
__device__ uint32_t simplicial_collapse(const uint32_t* __restrict__ rbuf,
                                        const uint32_t (&s)[W], int n,
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

// Minor-min-width lower bound of one state (repro.core.mmw.mmw_bound),
// run by the whole warp.  `reach` (n rows, shared or device memory) is
// read once; `adjm` (n rows of shared memory, may alias nothing else the
// warp reads) holds the contracted graph.  Each step contracts the
// minimum-degree active vertex v into its minimum-degree neighbour u (v
// itself when isolated); ties go to the lowest index, as jnp.argmin's,
// by taking the warp minimum of (degree << 8) | index (n <= 256).  The
// loop stops once the bound exceeds k or at most one vertex is active.
template <int W>
__device__ int mmw_warp(const uint32_t* __restrict__ reach,
                        uint32_t* __restrict__ adjm, const uint32_t (&s)[W],
                        int n, int k, int lane) {
  uint32_t active[W];
  int nact = 0;
#pragma unroll
  for (int x = 0; x < W; ++x) {
    const int rem = n - 32 * x;
    const uint32_t full =
        rem >= 32 ? kFull : (rem > 0 ? (1u << rem) - 1u : 0u);
    active[x] = full & ~s[x];
    nact += __popc(active[x]);
  }
#pragma unroll
  for (int r = 0; r < W; ++r) {
    const int i = lane + kWarp * r;
    if (i >= n) break;
    const bool act = has_bit<W>(active, i);
#pragma unroll
    for (int x = 0; x < W; ++x) {
      uint32_t v = reach[i * W + x] & active[x];
      if (x == (i >> 5)) v &= ~(1u << (i & 31));
      adjm[i * W + x] = act ? v : 0u;
    }
  }
  __syncwarp();

  int lb = 0;
  while (nact > 1 && lb <= k) {
    unsigned key[W];
    unsigned best = kFull;
#pragma unroll
    for (int r = 0; r < W; ++r) {
      const int i = lane + kWarp * r;
      key[r] = kFull;
      if (i >= n) continue;
      unsigned d = kBig;
      if (has_bit<W>(active, i)) {
        d = 0;
#pragma unroll
        for (int x = 0; x < W; ++x) d += __popc(adjm[i * W + x]);
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
#pragma unroll
    for (int x = 0; x < W; ++x) vrow[x] = adjm[v * W + x];
    int u = v;
    if (dv > 0) {
      unsigned bestn = kFull;
#pragma unroll
      for (int r = 0; r < W; ++r) {
        const int i = lane + kWarp * r;
        if (i >= n) continue;
        const unsigned dn = has_bit<W>(vrow, i) ? (key[r] >> 8) : kBig;
        bestn = min(bestn, (dn << 8) | (unsigned)i);
      }
      u = (int)(__reduce_min_sync(kFull, bestn) & 255u);
    }
    uint32_t merged[W];
#pragma unroll
    for (int x = 0; x < W; ++x)
      merged[x] = (vrow[x] | adjm[u * W + x]) & active[x];
    set_bit<W>(merged, u, false);
    set_bit<W>(merged, v, false);
    __syncwarp();                       // every lane has read rows v and u
#pragma unroll
    for (int r = 0; r < W; ++r) {
      const int i = lane + kWarp * r;
      if (i >= n) break;
      uint32_t row[W];
#pragma unroll
      for (int x = 0; x < W; ++x) row[x] = adjm[i * W + x];
      set_bit<W>(row, u, false);                       // clear column u
      set_bit<W>(row, v, has_bit<W>(merged, i));       // fix column v
      if (i == v) {
#pragma unroll
        for (int x = 0; x < W; ++x) row[x] = merged[x];
      }
      if (i == u) {
#pragma unroll
        for (int x = 0; x < W; ++x) row[x] = 0u;
      }
#pragma unroll
      for (int x = 0; x < W; ++x) adjm[i * W + x] = row[x];
    }
    __syncwarp();
    set_bit<W>(active, u, false);
    --nact;
  }
  return lb;
}

}  // namespace rt
