"""One rung of the deepening ladder, in plain PyTorch: is tw(G) <= k?

Written for the benchmark from the semantics the solver documents (the
paper's Listing 1 with the clique rule, the MMW prune of §3.3, exact or
Bloom dedup into a fixed-capacity list), not from the program's code.
It imports nothing of the program and runs on any device.

A state is a set S of eliminated vertices, held as an int64 bit mask
(n <= 62).  Per level, every state S and every candidate v (not in S,
not in the clique) gives the child S + {v} when |Q(S, v)| <= k, where
Q(S, v) are the vertices outside S + {v} reachable from v through S.
The reach is computed for all vertices at once as R_S = paths whose
interior lies in S, by doubling: R <- R | R diag(S) R.

What survives an overflow depends on the order in which children reach
the fixed list, so the geometry is the solver's:

* a level runs in ``block``-state chunks, or in one ``SMALL_BLOCK``
  chunk when its whole frontier fits there;
* each chunk's children are sorted (the unsigned lexicographic order of
  their 32-bit words, word 0 first), made unique and appended in that
  order; rows past ``cap`` are dropped;
* sort mode: a level that spanned several chunks is sorted and made
  unique once more over the whole list;
* Bloom mode: the solver's filter, fresh each level: ``m_bits`` bits,
  ``k_hashes`` probes at (h1 + j h2 mod 2^32) mod m_bits, h1 and h2 the
  murmur3 x86 32-bit hashes of the child's ``w`` 32-bit words under the
  solver's two documented seeds.  Children are queried and inserted in
  append order, dropped ones too: a child is new when one of its probes
  finds a zero bit that no earlier child of the level probed.  False
  positives drop states as the program's filter does; there is no
  second pass.

``dedup="bloom_small"`` is the control of the benchmark: a Bloom filter
of ``CONTROL_BITS`` bits and ``CONTROL_PROBES`` multiplicative probes.

With ``use_mmw`` a state whose eliminated graph has a minor-min-width
bound above k has no children.  ``n_pad`` embeds the graph in that many
vertices (the extra ones isolated and never candidates), as a multi-lane
dispatch does; it changes only the MMW bound.
"""
from __future__ import annotations

import math

import torch

SMALL_BLOCK = 128
MAX_N = 62
# states per batch of the reach computation (a multiple of the chunk)
BATCH_STATES = 1 << 15
# the control's filter: bits and probes
CONTROL_BITS = 1 << 10
CONTROL_PROBES = 3
# murmur3 x86 32-bit: the two seeds of the solver's Bloom filter
MURMUR_SEEDS = (0x9747B28C, 0x31415926)
M32 = 0xFFFFFFFF

_SIGN = -(1 << 63)


def sort_keys(masks: torch.Tensor) -> torch.Tensor:
    """int64 keys whose signed order is the unsigned lexicographic order
    of the masks' 32-bit words, word 0 (bits 0..31) first."""
    lo = masks & 0xFFFFFFFF
    hi = masks >> 32
    return ((lo << 32) | hi) ^ torch.tensor(_SIGN, dtype=torch.int64,
                                            device=masks.device)


def _bits(masks: torch.Tensor, n: int) -> torch.Tensor:
    ar = torch.arange(n, device=masks.device)
    return ((masks[:, None] >> ar[None, :]) & 1).bool()


def reach(adj: torch.Tensor, s_bits: torch.Tensor) -> torch.Tensor:
    """R (P, n, n) bool: R[p, v, w] iff a path v .. w has every interior
    vertex in S_p.  adj (n, n) bool, s_bits (P, n) bool."""
    p, n = s_bits.shape
    dt = torch.float16 if adj.device.type == "cuda" else torch.float32
    r = adj[None].expand(p, n, n).clone()
    s = s_bits.to(dt)[:, None, :]
    for _ in range(max(1, math.ceil(math.log2(max(n - 1, 2)))) + 1):
        rf = r.to(dt)
        nxt = r | (torch.bmm(rf * s, rf) > 0)
        if torch.equal(nxt, r):
            break
        r = nxt
    return r


def mmw(rows: torch.Tensor, act: torch.Tensor, k: int) -> torch.Tensor:
    """Minor-min-width bound per state, stopped once it exceeds k or can no
    longer exceed it (then the value returned is at most k).

    rows (R, m) int64: bit x of rows[:, v] is the edge v-x of the graph,
    symmetric, no loops, only between active vertices; act (R, m) bool.
    Each step takes the first active vertex of least degree, raises the
    bound to the least degree among the others, and contracts into it
    its first neighbour of least degree (an isolated vertex is removed).
    Returns (R,) int64."""
    n_rows, m = rows.shape
    dev = rows.device
    big = m + 1
    ar = torch.arange(m, device=dev)
    bit = torch.ones((), dtype=torch.int64, device=dev) << ar
    rows, act = rows.clone(), act.clone()
    deg = ((rows[:, :, None] >> ar) & 1).sum(2)
    lb = torch.zeros(n_rows, dtype=torch.int64, device=dev)
    idx = torch.arange(n_rows, device=dev)
    out = torch.zeros(n_rows, dtype=torch.int64, device=dev)
    while idx.numel():
        # a later step's bound is at most nact - 1, so once that is <= k
        # the verdict (bound > k) can no longer change
        live = (act.sum(1) - 1 > k) & (lb <= k)
        out[idx[~live]] = lb[~live]
        idx, rows, act, lb, deg = (idx[live], rows[live], act[live],
                                   lb[live], deg[live])
        if not idx.numel():
            break
        r = torch.arange(idx.numel(), device=dev)
        d = torch.where(act, deg, big)
        v = d.argmin(1)
        vhot = ar[None] == v[:, None]
        lb = torch.maximum(lb, torch.where(vhot, big, d).min(1).values)
        row_v = rows[r, v]
        nb = ((row_v[:, None] >> ar) & 1).bool()
        u = torch.where(d[r, v] > 0, torch.where(nb, d, big).argmin(1), v)
        uhot = ar[None] == u[:, None]
        merged = (row_v | rows[r, u]) & ~bit[u] & ~bit[v]
        mbits = ((merged[:, None] >> ar) & 1).bool()
        # every other vertex loses its edges to u and v, and gains one to
        # v where it is in the merged neighbourhood
        old = ((rows >> u[:, None]) & 1) + ((rows >> v[:, None]) & 1)
        rows = (rows & ~(bit[u] | bit[v])[:, None]) | torch.where(
            mbits, bit[v][:, None], 0)
        deg = deg - old + mbits.long()
        rows[r, v] = merged
        deg[r, v] = mbits.sum(1)
        rows[r, u] = torch.where(u == v, merged, 0)
        deg[r, u] = torch.where(u == v, deg[r, v], 0)
        act &= ~uhot
    return out


def _children(adj, masks, k, allowed, n, n_pad, use_mmw):
    """Feasible children of a batch of states, as (state row, vertex)."""
    s_bits = _bits(masks, n)
    r = reach(adj, s_bits)
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    q = r & ~s_bits[:, None, :] & ~eye[None]
    deg = q.sum(2)
    cand = (~s_bits) & allowed[None] & (deg <= k)
    if use_mmw:
        rows = cand.any(1).nonzero().squeeze(1)
        if rows.numel():
            act = ~s_bits[rows]
            g = r[rows] & act[:, None, :] & act[:, :, None] & ~eye[None]
            packed = (g.long() << torch.arange(n, device=adj.device)).sum(2)
            if n_pad > n:
                packed = torch.nn.functional.pad(packed, (0, n_pad - n))
                act = torch.nn.functional.pad(act, (0, n_pad - n),
                                              value=True)
            lbs = mmw(packed, act, k)
            cand[rows] &= (lbs <= k)[:, None]
    return cand


def _bloom_hashes(keys: torch.Tensor) -> torch.Tensor:
    """The control's CONTROL_PROBES bit positions per key (multiplicative
    hashing)."""
    mult = (0x9E3779B97F4A7C15 - (1 << 64), 0x632BE59BD9B4E019,
            -0x3C6EF372FE94F82B)
    pos = [((keys * m) >> 40) & (CONTROL_BITS - 1)
           for m in mult[:CONTROL_PROBES]]
    return torch.stack(pos, 1)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """a * c mod 2^32 for a in [0, 2^32), without int64 overflow."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def murmur3(words: torch.Tensor, seed: int) -> torch.Tensor:
    """murmur3 x86 32-bit of each row of ``words`` ((R, w) int64, each a
    32-bit word in [0, 2^32), word 0 first, 4 w bytes a row)."""
    h = torch.full(words.shape[:1], seed, dtype=torch.int64,
                   device=words.device)
    for j in range(words.shape[1]):
        kv = _mul32(_rotl32(_mul32(words[:, j], 0xCC9E2D51), 15),
                    0x1B873593)
        h = _rotl32(h ^ kv, 13)
        h = (_mul32(h, 5) + 0xE6546B64) & M32
    h = h ^ (4 * words.shape[1])
    h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def probe_positions(words: torch.Tensor, m_bits: int,
                    k_hashes: int) -> torch.Tensor:
    """(R, k_hashes) bit positions (h1 + j h2 mod 2^32) mod m_bits."""
    h1, h2 = (murmur3(words, s) for s in MURMUR_SEEDS)
    j = torch.arange(k_hashes, device=words.device)
    h = (h1[:, None] + j[None] * h2[:, None]) & M32
    return h % m_bits


def mask_words(masks: torch.Tensor, w: int) -> torch.Tensor:
    """(R, w) 32-bit words of int64 state masks, word 0 = bits 0..31."""
    return torch.stack([(masks >> (32 * j)) & M32 for j in range(w)], 1)


def first_claims(pos: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Row-order query of a Bloom filter: row i (in order) is new when one
    of its probes p finds ``filt[p]`` unset and no earlier row probes p.
    pos (R, k) positions; returns (R,) bool.  Does not insert."""
    flat = pos.reshape(-1)
    o = torch.sort(flat, stable=True).indices
    fs = flat[o]
    lead = torch.ones_like(fs, dtype=torch.bool)
    lead[1:] = fs[1:] != fs[:-1]
    claim = torch.zeros_like(lead)
    claim[o] = lead & ~filt[fs]
    return claim.view(pos.shape).any(1)


def decide(adj_bool, n: int, k: int, clique, *, cap: int, block: int,
           dedup: str = "sort", use_mmw: bool = False, n_pad: int = None,
           m_bits: int = 1 << 24, k_hashes: int = 17, device="cpu",
           stats: dict = None):
    """Decide one rung.  ``adj_bool`` (n, n) numpy bool.  Returns
    (feasible, inexact, expanded).  The Bloom filter hashes ``w`` words a
    state, ``w`` the 32-bit words of ``n_pad`` vertices.  With ``stats``
    (Bloom mode only) each level appends to ``stats["inserted"]`` the
    distinct children inserted, and to ``stats["false_pos"]`` those
    the filter took as seen that the level had not seen (the distinct
    children it holds, and its false positives)."""
    if n > MAX_N:
        raise ValueError(f"the reference holds states in 62 bits; n={n}")
    target = n - max(k + 1, len(clique))
    if target <= 0:
        return True, False, 0
    n_pad = n if n_pad is None else max(n, int(n_pad))
    w = (n_pad + 31) // 32
    adj = torch.as_tensor(adj_bool, dtype=torch.bool, device=device)
    allowed = torch.ones(n, dtype=torch.bool, device=device)
    for v in clique:
        allowed[int(v)] = False
    one = torch.ones((), dtype=torch.int64, device=device)
    pow2 = one << torch.arange(n, device=device)
    small = min(block, SMALL_BLOCK)

    front = torch.zeros(1, dtype=torch.int64, device=device)
    expanded, dropped, level = 0, 0, 0
    while level < target and front.numel():
        count = front.numel()
        expanded += count
        level += 1
        blk = small if (small != block and count <= small) else block
        step = max(blk, BATCH_STATES // blk * blk)
        kept = []                  # appended rows, in append order
        room = cap
        filt = None
        if dedup in ("bloom", "bloom_small"):
            filt = torch.zeros(m_bits if dedup == "bloom" else CONTROL_BITS,
                               dtype=torch.bool, device=device)
        seen = torch.zeros(0, dtype=torch.int64, device=device)
        false_pos = 0
        for lo in range(0, count, step):
            masks = front[lo:lo + step]
            cand = _children(adj, masks, k, allowed, n, n_pad, use_mmw)
            st, vv = cand.nonzero(as_tuple=True)
            child = masks[st] | pow2[vv]
            chunk = (st + lo) // blk
            # sort by (chunk, key), then keep each chunk's first copies
            key = sort_keys(child)
            o = torch.sort(key, stable=True).indices
            o = o[torch.sort(chunk[o], stable=True).indices]
            key, chunk, child = key[o], chunk[o], child[o]
            first = torch.ones_like(key, dtype=torch.bool)
            first[1:] = (key[1:] != key[:-1]) | (chunk[1:] != chunk[:-1])
            key, chunk, child = key[first], chunk[first], child[first]
            if filt is not None:
                # query and insert in append order
                pos = (probe_positions(mask_words(child, w), m_bits,
                                       k_hashes) if dedup == "bloom"
                       else _bloom_hashes(key))
                new = first_claims(pos, filt)
                filt[pos.reshape(-1)] = True
                if stats is not None:
                    o2 = torch.sort(key, stable=True).indices
                    ks = key[o2]
                    fresh = torch.ones_like(ks, dtype=torch.bool)
                    fresh[1:] = ks[1:] != ks[:-1]
                    truly = torch.zeros_like(fresh)
                    truly[o2] = fresh
                    truly &= ~torch.isin(key, seen)
                    seen = torch.unique(torch.cat([seen, key]))
                    false_pos += int((truly & ~new).sum())
                child = child[new]
            take = child[:room]
            dropped += child.numel() - take.numel()
            room -= take.numel()
            kept.append(take)
        nxt = torch.cat(kept) if kept else front[:0]
        if dedup == "sort" and count > blk:
            o = torch.sort(sort_keys(nxt)).indices
            nxt = torch.unique_consecutive(nxt[o])
        front = nxt
        if stats is not None and filt is not None:
            stats.setdefault("inserted", []).append(int(seen.numel()))
            stats.setdefault("false_pos", []).append(false_pos)
    return bool(front.numel() > 0), dropped > 0, expanded
