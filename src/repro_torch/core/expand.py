"""Wavefront expansion: one level of the Held-Karp treewidth DP.

``wavefront_expand`` is the ``torch`` backend's ``wavefront_expand`` op
(``core.backend``) and the plain version of the CUDA wavefront kernel
(``repro_torch.kernels.wavefront``), which computes the same function bit
for bit.  It ports ``repro.core.expand.expand_block``,
``wavefront_expand`` and the two pruning rules: simplicial collapse
(``simplicial_viol``, ``simplicial_mask``, ``collapse_simplicial``) and
the MMW prune (``core.mmw.mmw_bound``), applied in the reference's order.
"""
from __future__ import annotations

import torch

from . import bitset, components
from . import mmw as mmw_lib


def expand_block(adj: torch.Tensor, states: torch.Tensor,
                 valid: torch.Tensor, k: int, allowed: torch.Tensor, n: int,
                 schedule: str = "doubling"):
    """Expand a block of states.

    adj (n, W) int32 words; states (B, W); valid (B,) bool; k int;
    allowed (W,) candidate mask.

    Returns (children (B, n, W), feasible (B, n) bool, degrees (B, n)
    int32, reach (B, n, W)).  Degrees and reach are computed for the
    valid rows only and are 0 on invalid rows, which are infeasible
    whatever their degrees (the reference computes them for every row).
    ``schedule="matmul"`` takes ``components.eliminated_degrees_matmul``,
    whose reach is Q(S, v), as the reference's does.
    """
    b, w = states.shape
    rows = valid.nonzero().squeeze(1)
    degrees = torch.zeros((b, n), dtype=torch.int32, device=adj.device)
    reach = torch.zeros((b, n, w), dtype=torch.int32, device=adj.device)
    if rows.numel() and schedule == "matmul":
        degrees[rows], reach[rows] = components.eliminated_degrees_matmul(
            adj, states[rows], n)
    elif rows.numel():
        degrees[rows], reach[rows] = components.eliminated_degrees(
            adj, states[rows], n, schedule=schedule)
    in_s = bitset.unpack(states, n)                          # (B, n)
    allowed_bits = bitset.unpack(allowed, n)                 # (n,)
    feasible = ((degrees <= int(k))
                & ~in_s
                & allowed_bits[None, :]
                & valid[:, None])
    eye = bitset.eye_words(n, adj.shape[-1], adj.device)     # (n, W)
    children = states[:, None, :] | eye[None, :, :]          # (B, n, W)
    return children, feasible, degrees, reach


def simplicial_viol(q: torch.Tensor, closed: torch.Tensor,
                    n: int) -> torch.Tensor:
    """viol (B, n) bool: candidate v has a witness u in Q_v whose closed
    eliminated-graph neighbourhood misses part of Q_v (so Q_v is no
    clique).  q, closed: (B, n, W) int32 words.

    ``miss[b, v, u]`` counts the x in Q_v outside closed[u] with a float32
    batched matmul of 0/1 matrices (counts <= n, exact)."""
    qb = bitset.unpack(q, n).to(torch.float32)                # (B, v, x)
    open_ = (~bitset.unpack(closed, n)).to(torch.float32)     # (B, u, x)
    miss = torch.matmul(qb, open_.transpose(1, 2)) > 0        # (B, v, u)
    return torch.any((qb > 0) & miss, dim=-1)


def simplicial_mask(adj, states, reach, feasible, n: int) -> torch.Tensor:
    """Per (state, v): is v a feasible simplicial vertex of the eliminated
    graph G_S?  Eliminating one first is safe, so the caller collapses
    ``feasible`` to one such v.

    adj (n, W); states (B, W); reach (B, n, W); feasible (B, n) ->
    (B, n) bool."""
    eye = bitset.eye_words(n, adj.shape[-1], adj.device)
    q = (reach & ~states[:, None, :]) & ~eye[None]            # Q(S, v)
    closed = reach | eye[None]                                # N[u]
    return feasible & ~simplicial_viol(q, closed, n)


def collapse_simplicial(feasible: torch.Tensor,
                        simp: torch.Tensor) -> torch.Tensor:
    """If any simplicial candidate exists, keep only the lowest-index one."""
    has = torch.any(simp, dim=-1, keepdim=True)
    idx = torch.argmax(simp.to(torch.uint8), dim=-1)          # first True
    only = (torch.arange(simp.shape[-1], device=simp.device)[None, :]
            == idx[:, None]) & simp
    return torch.where(has, only, feasible)


def wavefront_expand(adj, states, valid, k, allowed, *, n: int,
                     schedule: str = "doubling", use_mmw: bool = False,
                     use_simplicial: bool = False):
    """The Listing-1 inner loop, torch backend: expand a block, apply the
    feasibility test and the enabled pruning rules (simplicial collapse,
    then the MMW prune, as the reference).

    Returns (children (B, n, W) int32 words, feasible (B, n) bool).  With a
    leading lane axis (adj (L, n, W), states (L, B, W), valid (L, B), k an
    (L,) tensor, allowed (L, W)) each lane is expanded on its own and the
    outputs gain the lane axis."""
    if states.dim() == 3:
        outs = [wavefront_expand(adj[i], states[i], valid[i], kk,
                                 allowed[i], n=n, schedule=schedule,
                                 use_mmw=use_mmw,
                                 use_simplicial=use_simplicial)
                for i, kk in enumerate(k.tolist())]
        return (torch.stack([c for c, _ in outs]),
                torch.stack([f for _, f in outs]))
    children, feasible, _deg, reach = expand_block(
        adj, states, valid, k, allowed, n, schedule=schedule)
    if use_simplicial:
        simp = simplicial_mask(adj, states, reach, feasible, n)
        feasible = collapse_simplicial(feasible, simp)
    if use_mmw:
        # only rows with a feasible candidate can change; the bound of the
        # others is never read
        rows = feasible.any(dim=1).nonzero().squeeze(1)
        if rows.numel():
            lbs = mmw_lib.mmw_bound(reach[rows], states[rows], k, n=n)
            feasible[rows] &= (lbs <= int(k))[:, None]
    return children, feasible


def degree_oracle(adj_bool, s: set, v: int) -> int:
    """Host-side python oracle: |Q(S, v)| by explicit BFS (paper Listing 1)."""
    n = len(adj_bool)
    seen = [False] * n
    stack = [v]
    seen[v] = True
    degree = 0
    while stack:
        u = stack.pop()
        for wv in range(n):
            if adj_bool[u][wv] and not seen[wv]:
                seen[wv] = True
                if wv in s:
                    stack.append(wv)
                else:
                    degree += 1
    return degree
