"""Wavefront expansion: one level of the Held-Karp treewidth DP.

``wavefront_expand`` is the ``torch`` backend's ``wavefront_expand`` op
(``core.backend``) and the plain version of the CUDA wavefront kernel
(``repro_torch.kernels.wavefront``), which computes the same function bit
for bit.  It ports ``repro.core.expand.expand_block`` and
``wavefront_expand`` without the pruning rules.
"""
from __future__ import annotations

import torch

from . import bitset, components


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
    """
    b, w = states.shape
    rows = valid.nonzero().squeeze(1)
    degrees = torch.zeros((b, n), dtype=torch.int32, device=adj.device)
    reach = torch.zeros((b, n, w), dtype=torch.int32, device=adj.device)
    if rows.numel():
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


def wavefront_expand(adj, states, valid, k, allowed, *, n: int,
                     schedule: str = "doubling", use_mmw: bool = False,
                     use_simplicial: bool = False):
    """The Listing-1 inner loop, torch backend: expand a block and apply
    the feasibility test.

    Returns (children (B, n, W) int32 words, feasible (B, n) bool)."""
    if use_mmw or use_simplicial:
        raise ValueError(
            "the pruning rules (use_mmw, use_simplicial) are not ported "
            "yet (ROADMAP B3, B4)")
    children, feasible, _deg, _reach = expand_block(
        adj, states, valid, k, allowed, n, schedule=schedule)
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
