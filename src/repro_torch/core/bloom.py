"""Bloom filter duplicate detection (the paper's mode, ``repro.core.bloom``).

Murmur3 (32-bit) double hashing as in the paper: two hashes ``h1, h2``
combined linearly, ``H_i = h1 + i*h2`` (Kirsch-Mitzenmacher), ``k = 17``
probes, ``m/n >= 24`` bits per element.  This module is the ``torch``
backend's filter: one byte per bit, the whole batch queried before any of
it is inserted (the reference's ``query_and_insert``).  The packed filter
with row-order inserts is the ``cuda`` backend's
(``repro_torch.kernels.bloom``).  The two agree whenever no two rows of a
batch share probe bits; the engine's sort-dedup runs first, so at the
solver's sizes they differ only on a false positive inside one chunk.

Words are int32 bit patterns; hashes are computed in int64 and masked to
32 bits after every step, so every product stays below 2^63.  Hashes come
back as int64 values in ``[0, 2^32)``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .bitset import MASK32

C1 = 0xCC9E2D51
C2 = 0x1B873593
MIX1 = 0x85EBCA6B
MIX2 = 0xC2B2AE35
SEED1 = 0x9747B28C
SEED2 = 0x31415926
DEFAULT_K = 17           # paper §3.2
DEFAULT_BITS_PER_ELEM = 24


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for values in [0, 2^32), without int64 overflow."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def murmur3_words(words: torch.Tensor, seed: int) -> torch.Tensor:
    """Murmur3 x86 32-bit over (..., W) int32 words -> (...,) int64 hashes
    in [0, 2^32)."""
    w = words.shape[-1]
    h = torch.full(words.shape[:-1], seed & MASK32, dtype=torch.int64,
                   device=words.device)
    for j in range(w):
        kv = words[..., j].to(torch.int64) & MASK32
        kv = _mul32(kv, C1)
        kv = _rotl(kv, 15)
        kv = _mul32(kv, C2)
        h = h ^ kv
        h = _rotl(h, 13)
        h = (_mul32(h, 5) + 0xE6546B64) & MASK32
    h = h ^ (w * 4)
    h = h ^ (h >> 16)
    h = _mul32(h, MIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, MIX2)
    h = h ^ (h >> 16)
    return h


def murmur3_ref(words, seed: int) -> int:
    """Pure-python oracle for tests (words as unsigned or int32 values)."""
    mask = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & mask

    h = seed & mask
    for kv in words:
        kv = int(kv) & mask
        kv = (kv * 0xCC9E2D51) & mask
        kv = rotl(kv, 15)
        kv = (kv * 0x1B873593) & mask
        h ^= kv
        h = rotl(h, 13)
        h = (h * 5 + 0xE6546B64) & mask
    h ^= len(words) * 4
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & mask
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & mask
    h ^= h >> 16
    return h


def probe_indices(words: torch.Tensor, m_bits: int,
                  k_hashes: int = DEFAULT_K) -> torch.Tensor:
    """(..., W) -> (..., k) int64 filter positions ``H_i = h1 + i*h2``,
    wrapped at 2^32 before ``mod m_bits`` as the reference's uint32 sum."""
    h1 = murmur3_words(words, SEED1)
    h2 = murmur3_words(words, SEED2)
    i = torch.arange(k_hashes, dtype=torch.int64, device=words.device)
    idx = (h1[..., None] + _mul32(h2[..., None], i)) & MASK32
    return idx % m_bits


def query(filt: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """filt (m,) uint8 0/1; idx (..., k) -> (...,) bool 'maybe present'."""
    return torch.all(filt[idx] == 1, dim=-1)


def insert(filt: torch.Tensor, idx: torch.Tensor,
           valid: torch.Tensor) -> torch.Tensor:
    """Set the probe bits of all valid elements, in place; returns filt."""
    filt[idx[valid].reshape(-1)] = 1
    return filt


def make_filter(m_bits: int, device=None,
                lanes: Optional[int] = None) -> torch.Tensor:
    """An empty filter of ``m_bits`` bytes, or one per lane, (lanes,
    m_bits)."""
    lead = () if lanes is None else (lanes,)
    return torch.zeros(lead + (m_bits,), dtype=torch.uint8, device=device)


def query_and_insert(filt, words, valid, m_bits: int,
                     k_hashes: int = DEFAULT_K):
    """Returns (was_new (...,) bool, filter).

    An element is 'new' iff any probed bit was zero before the batch.
    Duplicates *within* ``words`` all report new: callers dedup the batch
    first.  Unlike the reference, which returns a new array, the filter is
    updated in place (it is 16 MiB at the solver's default size) and
    returned.  A filter with a lane axis, (L, m_bits), holds one filter
    per lane: words (L, ..., W) and valid (L, ...) then go lane by lane
    into their own filter, each batch queried before it is inserted.
    """
    lanes = filt.shape[0] if filt.dim() == 2 else 1
    flat_filt = filt.reshape(-1)
    valid2 = valid.reshape(lanes, -1)
    words2 = words.reshape(lanes, -1, words.shape[-1])
    # only valid rows are hashed: the others are neither new nor inserted
    lane, row = valid2.nonzero(as_tuple=True)
    idx = probe_indices(words2[lane, row], m_bits, k_hashes) \
        + lane[:, None] * m_bits
    was_new = torch.zeros(valid2.shape, dtype=torch.bool,
                          device=valid.device)
    was_new[lane, row] = ~query(flat_filt, idx)
    insert(flat_filt, idx, torch.ones_like(row, dtype=torch.bool))
    return was_new.reshape(valid.shape), filt
