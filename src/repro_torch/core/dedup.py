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
"""
from __future__ import annotations

import torch

from .bitset import MASK32

SENTINEL = -1          # 0xFFFFFFFF as an int32 bit pattern


def sort_states(keys: torch.Tensor, valid: torch.Tensor):
    """Lexicographically sort rows of (M, W) with invalid rows sent to the
    end.  Returns (sorted_keys (M, W), sorted_valid (M,))."""
    m, w = keys.shape
    keys = torch.where(valid[:, None], keys,
                       torch.full_like(keys, SENTINEL))
    perm = torch.arange(m, device=keys.device)
    for j in range(w - 1, -1, -1):
        col = keys[perm, j].to(torch.int64) & MASK32
        perm = perm[torch.sort(col, stable=True).indices]
    return keys[perm], valid[perm]


def unique_mask(sorted_keys: torch.Tensor, sorted_valid: torch.Tensor):
    """First-occurrence mask over sorted rows."""
    diff = torch.any(sorted_keys[1:] != sorted_keys[:-1], dim=1)
    first = torch.cat([torch.ones((1,), dtype=torch.bool,
                                  device=sorted_keys.device), diff])
    return first & sorted_valid


def compact(rows: torch.Tensor, keep: torch.Tensor, cap: int, offset=0,
            out: torch.Tensor = None):
    """Scatter kept rows into a (cap, W) buffer starting at ``offset``.

    ``out`` is an optional ``(cap + 1, W)`` buffer to append into (row
    ``cap`` is the drop slot); a fresh zero buffer otherwise.  ``offset``
    may be an int or a 0-d tensor.  Returns (buffer (cap, W), n_written,
    n_dropped) with the counts as 0-d int64 tensors.
    """
    w = rows.shape[-1]
    pos = torch.cumsum(keep.to(torch.int64), dim=0) - 1 + offset
    n_keep = keep.to(torch.int64).sum()
    idx = torch.where(keep & (pos < cap), pos,
                      torch.full_like(pos, cap))             # cap == drop slot
    if out is None:
        out = torch.zeros((cap + 1, w), dtype=rows.dtype, device=rows.device)
    out.index_put_((idx,), rows)
    room = torch.clamp(cap - torch.as_tensor(offset, device=rows.device),
                       min=0)
    written = torch.minimum(n_keep, room)
    return out[:cap], written, n_keep - written


def dedup_compact(keys: torch.Tensor, valid: torch.Tensor, cap: int):
    """Sort-dedup rows and compact into a fresh (cap, W) frontier buffer.

    Returns (buffer, count, dropped)."""
    sk, sv = sort_states(keys, valid)
    keep = unique_mask(sk, sv)
    return compact(sk, keep, cap)
