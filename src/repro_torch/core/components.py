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
result is bit-identical to the word-level product.

The closure schedules are the reference's (the paper's Table-6 sweep),
and every one reaches the same fixpoint:

  doubling  ``ceil(log2 n)`` squarings ``Z |= Z.Z`` (a static trip count;
            the CUDA kernels run this one only)
  while     squarings until nothing changes
  linear    one-hop propagation ``Z |= M.Z`` with ``M = adj & S`` on the
            rows of S, until nothing changes (up to n steps)
  matmul    ``eliminated_degrees_matmul``, the dense float 0/1
            formulation, which reports Q(S, v) (S and v removed) as its
            reach

``while`` and ``linear`` test for a change with one host read per step.

Functions are batched: ``s_words`` is ``(B, W)`` and results carry the
leading ``B`` axis.
"""
from __future__ import annotations

import functools

import numpy as np
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


def _closure_bits(adj_bits: torch.Tensor, s_bits: torch.Tensor, n: int,
                  schedule: str = "doubling") -> torch.Tensor:
    """Unpacked closure under ``schedule``: adj_bits (n, n) f32, s_bits
    (B, n) f32 -> (B, n, n)."""
    eye = torch.eye(n, dtype=torch.float32, device=adj_bits.device)
    inner = s_bits[:, :, None] * s_bits[:, None, :]
    z = torch.clamp(adj_bits[None] * inner + eye[None] * s_bits[:, :, None],
                    max=1.0)
    if schedule == "doubling":
        for _ in range(log2_ceil(max(n, 2))):
            z = torch.clamp(z + _bool_mm(z, z), max=1.0)
        return z
    if schedule == "linear":
        m = adj_bits[None] * inner            # adj & S on the rows of S
    elif schedule != "while":
        raise ValueError(f"unknown schedule {schedule!r}")
    while True:
        hop = _bool_mm(z, z) if schedule == "while" else _bool_mm(m, z)
        z2 = torch.clamp(z + hop, max=1.0)
        if torch.equal(z2, z):
            return z
        z = z2


def closure(adj: torch.Tensor, s_words: torch.Tensor, n: int,
            schedule: str = "doubling", unroll: int = 1) -> torch.Tensor:
    """Component closure Z of G[S].  adj (n, W); s_words (B, W) -> (B, n, W).

    ``unroll`` is the reference's loop-unroll hint for XLA; it is accepted
    and does nothing here."""
    del unroll
    adj_bits = bitset.unpack(adj, n).to(torch.float32)
    s_bits = bitset.unpack(s_words, n).to(torch.float32)
    return bitset.pack(_closure_bits(adj_bits, s_bits, n, schedule) > 0, n)


def _reach_bits(adj: torch.Tensor, s_words: torch.Tensor, n: int,
                schedule: str = "doubling"):
    adj_bits = bitset.unpack(adj, n).to(torch.float32)             # (n, n)
    s_bits = bitset.unpack(s_words, n).to(torch.float32)           # (B, n)
    z = _closure_bits(adj_bits, s_bits, n, schedule)               # (B, n, n)
    nb = _bool_mm(z, adj_bits)                                     # N(comp i)
    via_s = _bool_mm(adj_bits[None] * s_bits[:, None, :], nb)      # hop via S
    reach = torch.clamp(adj_bits[None] + via_s, max=1.0)
    return reach, s_bits


def reach_matrix(adj: torch.Tensor, s_words: torch.Tensor, n: int,
                 schedule: str = "doubling") -> torch.Tensor:
    """R (B, n, W): what each v reaches through S.  Rows of v in S are
    garbage; callers mask them."""
    reach, _ = _reach_bits(adj, s_words, n, schedule)
    return bitset.pack(reach > 0, n)


def eliminated_degrees(adj: torch.Tensor, s_words: torch.Tensor, n: int,
                       schedule: str = "doubling"):
    """deg_S(v) for every v (values for v in S are meaningless; mask them).

    Returns (degrees (B, n) int32, reach R (B, n, W))."""
    reach, s_bits = _reach_bits(adj, s_words, n, schedule)
    q = _q_bits(reach, s_bits, n)
    return q.sum(dim=-1).to(torch.int32), bitset.pack(reach > 0, n)


def eliminated_degrees_matmul(adj: torch.Tensor, s_words: torch.Tensor,
                              n: int):
    """deg_S(v) by dense 0/1 float matmuls: the reference's ``matmul``
    schedule.  Same degrees as ``eliminated_degrees``, but the reach it
    returns is Q(S, v), with S and v removed, as the reference's is.

    Returns (degrees (B, n) int32, Q packed (B, n, W))."""
    reach, s_bits = _reach_bits(adj, s_words, n)
    q = _q_bits(reach, s_bits, n)
    return q.sum(dim=-1).to(torch.int32), bitset.pack(q > 0, n)


def _q_bits(reach: torch.Tensor, s_bits: torch.Tensor, n: int):
    """Q(S, v) unpacked: the reach of v without S and without v."""
    eye = torch.eye(n, dtype=torch.float32, device=reach.device)
    return reach * (1.0 - s_bits)[:, None, :] * (1.0 - eye)[None]


@functools.lru_cache(maxsize=None)
def _eye_np(n: int, w: int) -> np.ndarray:
    """(n, W) uint32 identity bitset matrix on the host (read-only)."""
    out = np.zeros((n, w), dtype=np.uint32)
    idx = np.arange(n)
    out[idx, idx >> 5] = np.uint32(1) << (idx & 31).astype(np.uint32)
    out.flags.writeable = False
    return out


def _eye_words(n: int, w: int, device=None) -> torch.Tensor:
    """``_eye_np`` as int32 words on ``device``."""
    return bitset.to_words(_eye_np(n, w), device)
