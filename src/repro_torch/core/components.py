"""Bit-parallel elimination reachability (``repro.core.components``).

For a state S the paper runs one DFS per candidate v to find deg_S(v)
(Listing 1, lines 7-19).  Here, as in the reference, it is dense set
algebra computed once per state and shared by every candidate:

  Z  (n, W): component closure of G[S] (rows of S only, else empty)
  NB (n, W): ``NB[i] = N(Z[i])``
  R  (n, W): ``R[v] = N(v) | OR_{i in N(v) & S} NB[i]``
  deg_S(v) = |R[v] \\ S \\ {v}|

Each OR-AND product is taken on unpacked 0/1 matrices with a float32
batched matmul and ``> 0``.  Entries are counts of at most ``n``, exact in
float32 for any ``n < 2^24`` (and in TF32's 0/1 inputs alike), so the
result is bit-identical to the word-level product.  Only the ``doubling``
schedule is ported: ``ceil(log2 n)`` squarings ``Z |= Z.Z``; every
schedule reaches the same fixpoint.

Functions are batched: ``s_words`` is ``(B, W)`` and results carry the
leading ``B`` axis.
"""
from __future__ import annotations

import torch

from . import bitset


def log2_ceil(n: int) -> int:
    """Static doubling trip count: smallest b >= 1 with 2**b >= n."""
    b = 1
    while (1 << b) < n:
        b += 1
    return b


def _bool_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """OR-AND product of 0/1 float32 matrices -> 0/1 float32."""
    return (torch.matmul(a, b) > 0).to(torch.float32)


def _closure_bits(adj_bits: torch.Tensor, s_bits: torch.Tensor,
                  n: int) -> torch.Tensor:
    """Unpacked closure: adj_bits (n, n) f32, s_bits (B, n) f32 -> (B, n, n)."""
    eye = torch.eye(n, dtype=torch.float32, device=adj_bits.device)
    inner = s_bits[:, :, None] * s_bits[:, None, :]
    z = torch.clamp(adj_bits[None] * inner + eye[None] * s_bits[:, :, None],
                    max=1.0)
    for _ in range(log2_ceil(max(n, 2))):
        z = torch.clamp(z + _bool_mm(z, z), max=1.0)
    return z


def closure(adj: torch.Tensor, s_words: torch.Tensor, n: int,
            schedule: str = "doubling") -> torch.Tensor:
    """Component closure Z of G[S].  adj (n, W); s_words (B, W) -> (B, n, W)."""
    _check_schedule(schedule)
    adj_bits = bitset.unpack(adj, n).to(torch.float32)
    s_bits = bitset.unpack(s_words, n).to(torch.float32)
    return bitset.pack(_closure_bits(adj_bits, s_bits, n) > 0, n)


def _reach_bits(adj: torch.Tensor, s_words: torch.Tensor, n: int):
    adj_bits = bitset.unpack(adj, n).to(torch.float32)             # (n, n)
    s_bits = bitset.unpack(s_words, n).to(torch.float32)           # (B, n)
    z = _closure_bits(adj_bits, s_bits, n)                         # (B, n, n)
    nb = _bool_mm(z, adj_bits)                                     # N(comp i)
    via_s = _bool_mm(adj_bits[None] * s_bits[:, None, :], nb)      # hop via S
    reach = torch.clamp(adj_bits[None] + via_s, max=1.0)
    return reach, s_bits


def reach_matrix(adj: torch.Tensor, s_words: torch.Tensor, n: int,
                 schedule: str = "doubling") -> torch.Tensor:
    """R (B, n, W): what each v reaches through S.  Rows of v in S are
    garbage; callers mask them."""
    _check_schedule(schedule)
    reach, _ = _reach_bits(adj, s_words, n)
    return bitset.pack(reach > 0, n)


def eliminated_degrees(adj: torch.Tensor, s_words: torch.Tensor, n: int,
                       schedule: str = "doubling"):
    """deg_S(v) for every v (values for v in S are meaningless; mask them).

    Returns (degrees (B, n) int32, reach R (B, n, W))."""
    _check_schedule(schedule)
    reach, s_bits = _reach_bits(adj, s_words, n)
    eye = torch.eye(n, dtype=torch.float32, device=adj.device)
    q = reach * (1.0 - s_bits)[:, None, :] * (1.0 - eye)[None]
    return q.sum(dim=-1).to(torch.int32), bitset.pack(reach > 0, n)


def _check_schedule(schedule: str) -> None:
    if schedule != "doubling":
        raise ValueError(
            f"schedule={schedule!r} is not ported; the port runs the "
            "static 'doubling' closure only (ROADMAP A3)")
