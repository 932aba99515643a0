"""Frontier capacity planning (``repro.core.batch:75-160``).

Only ``plan_capacity`` and its power-of-two helpers are ported so far:
``solve_block`` needs them when ``cap=None``.  The multi-lane engine of
``repro.core.batch`` comes with a later slice.
"""
from __future__ import annotations

import math
from typing import Optional

from . import bitset

# the historical fixed frontier capacity; ``cap=None`` means
# "plan_capacity, clamped to this"
DEFAULT_CAP = 1 << 17


def plan_capacity(n: int, w: Optional[int] = None, *, lanes: int = 1,
                  block: int = 1 << 11, cap_max: int = DEFAULT_CAP,
                  budget_bytes=None) -> int:
    """Right-size the per-lane frontier capacity for an ``n``-vertex block.

    The smallest power-of-two buffer that provably never drops a state
    the fixed ``cap_max`` buffer would have kept: one level appends at
    most ``n * C(n, floor(n/2))`` rows.  Never below ``block`` (chunk
    geometry must match a fixed-``cap`` run) nor below 32.
    ``budget_bytes`` bounds the ``lanes``-wide pool of
    ``lanes * cap * W * 4`` bytes; a binding budget may reintroduce drops.
    """
    if n <= 1:
        need = 1
    else:
        need = n * math.comb(n, n // 2) + 1
    cap_hi = _pow2_floor(cap_max)
    cap = min(_pow2_at_least(need), cap_hi)
    cap = max(cap, 32, _pow2_at_least(min(block, cap_hi)))
    if budget_bytes is not None:
        row_bytes = 4 * max(1, w if w is not None else bitset.n_words(n))
        afford = int(budget_bytes) // (max(1, lanes) * row_bytes)
        cap = max(32, min(cap, _pow2_floor(afford)))
    return cap


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _pow2_floor(x: int) -> int:
    p = 1
    while p * 2 <= x:
        p *= 2
    return p
