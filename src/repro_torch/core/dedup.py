"""Exact duplicate elimination by multi-word sort (``repro.core.dedup``).

Rows of W int32 words are sorted in **unsigned** lexicographic order, word
0 first, by stable ``torch.sort`` passes from the last word to the first
on int64 keys ``w & 0xFFFFFFFF``.  Invalid rows are replaced by the
all-ones sentinel, which is ``-1`` as int32: a signed sort would put it
first, and which rows survive an overflow would change.  Under the
unsigned order it sorts last and never equals a real state (the DP stops
before a state holds all n vertices).

A neighbour-difference mask keeps first occurrences, and ``compact``
scatters kept rows into a fixed ``(cap, W)`` buffer, dropping what lands
past ``cap`` (the paper's list-overflow semantics).

Every function also takes a leading lane axis (rows ``(L, M, W)``, masks
``(L, M)``) for the multi-lane engine: each lane is sorted on its own
(the lane is the most significant key, and the sentinel sorts last within
its lane), and ``compact`` appends each lane at its own offset into its
own ``(cap, W)`` buffer with its own drop count.
"""
from __future__ import annotations

import torch

from .bitset import MASK32

SENTINEL = -1          # 0xFFFFFFFF as an int32 bit pattern


def sort_states(keys: torch.Tensor, valid: torch.Tensor):
    """Lexicographically sort rows of ([L,] M, W) with invalid rows sent to
    the end of their lane.  Returns (sorted_keys, sorted_valid)."""
    w = keys.shape[-1]
    keys = torch.where(valid[..., None], keys,
                       torch.full_like(keys, SENTINEL))
    perm = torch.arange(keys.shape[-2], device=keys.device).expand(
        valid.shape)
    for j in range(w - 1, -1, -1):
        col = torch.gather(keys[..., j], -1, perm).to(torch.int64) & MASK32
        perm = torch.gather(perm, -1,
                            torch.sort(col, dim=-1, stable=True).indices)
    rows = torch.gather(keys, -2, perm[..., None].expand(keys.shape))
    return rows, torch.gather(valid, -1, perm)


def unique_mask(sorted_keys: torch.Tensor, sorted_valid: torch.Tensor):
    """First-occurrence mask over sorted rows (per lane)."""
    diff = torch.any(sorted_keys[..., 1:, :] != sorted_keys[..., :-1, :],
                     dim=-1)
    first = torch.ones(sorted_valid.shape[:-1] + (1,), dtype=torch.bool,
                       device=sorted_keys.device)
    return torch.cat([first, diff], dim=-1) & sorted_valid


def compact(rows: torch.Tensor, keep: torch.Tensor, cap: int, offset=0,
            out: torch.Tensor = None):
    """Scatter kept rows into a ([L,] cap, W) buffer starting at ``offset``.

    ``out`` is an optional contiguous ``([L,] cap + 1, W)`` buffer to
    append into (row ``cap`` is the drop slot); a fresh zero buffer
    otherwise.  ``offset`` may be an int, a 0-d tensor or, with a lane
    axis, an (L,) tensor.  Returns (buffer ([L,] cap, W), n_written,
    n_dropped) with the counts as int64 tensors of shape ``[L]``.
    """
    lead = keep.shape[:-1]
    w = rows.shape[-1]
    keep2 = keep.reshape(-1, keep.shape[-1])                  # (L, M)
    off = torch.as_tensor(offset, device=rows.device).to(
        torch.int64).reshape(-1, 1)                           # (L|1, 1)
    pos = torch.cumsum(keep2.to(torch.int64), dim=-1) - 1 + off
    n_keep = keep2.to(torch.int64).sum(dim=-1)
    idx = torch.where(keep2 & (pos < cap), pos,
                      torch.full_like(pos, cap))             # cap == drop slot
    if out is None:
        out = torch.zeros(lead + (cap + 1, w), dtype=rows.dtype,
                          device=rows.device)
    base = torch.arange(keep2.shape[0], device=rows.device)[:, None] \
        * (cap + 1)
    out.view(-1, w).index_put_(((idx + base).reshape(-1),),
                               rows.reshape(-1, w))
    room = torch.clamp(cap - off[:, 0], min=0)
    written = torch.minimum(n_keep, room)
    return (out[..., :cap, :], written.reshape(lead),
            (n_keep - written).reshape(lead))


def dedup_compact(keys: torch.Tensor, valid: torch.Tensor, cap: int):
    """Sort-dedup rows and compact into a fresh ([L,] cap, W) frontier
    buffer, lane by lane.

    Returns (buffer, count, dropped)."""
    sk, sv = sort_states(keys, valid)
    keep = unique_mask(sk, sv)
    return compact(sk, keep, cap)
