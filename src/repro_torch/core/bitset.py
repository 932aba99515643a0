"""Packed bitset algebra over int32 bit patterns.

A set over a universe of ``n`` vertices is ``W = ceil(n/32)`` 32-bit words,
bit ``i`` in word ``i >> 5`` at position ``i & 31`` (the layout of
``repro.core.bitset``).  Host arrays are numpy ``uint32``; device tensors
hold the same bits as ``torch.int32``, because torch's ``uint32`` has no
shifts, no ``~`` and no popcount.  Unsigned arithmetic is done in int64
(``w & 0xFFFFFFFF``) inside the torch ops.

A mask with bit 31 set is built in int64 and narrowed to int32, which
wraps to the right bit pattern; ``torch.tensor(1 << 31, dtype=torch.int32)``
would overflow instead.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def n_words(n: int) -> int:
    """Number of 32-bit words needed for an n-bit set."""
    return (n + 31) // 32


def np_full(n: int) -> np.ndarray:
    """(W,) uint32 bitset holding {0, ..., n-1}."""
    out = np.zeros((n_words(n),), dtype=np.uint32)
    for i in range(n):
        out[i >> 5] |= np.uint32(1) << np.uint32(i & 31)
    return out


def np_pack(sets, n: int) -> np.ndarray:
    """Host-side helper: list of python sets / iterables -> (len, W) uint32."""
    w = n_words(n)
    out = np.zeros((len(sets), w), dtype=np.uint32)
    for r, s in enumerate(sets):
        for i in s:
            out[r, i >> 5] |= np.uint32(1) << np.uint32(i & 31)
    return out


def np_unpack(words: np.ndarray, n: int) -> set:
    """(W,) uint32 -> python set."""
    return {i for i in range(n) if (int(words[i >> 5]) >> (i & 31)) & 1}


def np_allowed(n: int, skip=(), w: int = None) -> np.ndarray:
    """Host-side candidate mask: bits 0..n-1 set except ``skip`` (the
    clique skip set), zero-padded to ``w`` words."""
    full_words = np_full(n)
    out = np.zeros(w if w is not None else len(full_words), dtype=np.uint32)
    out[:len(full_words)] = full_words
    for v in skip:
        out[v >> 5] &= ~np.uint32(np.uint32(1) << np.uint32(v & 31))
    return out


def to_words(a: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 words -> int32 tensor holding the same bits."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def from_words(t: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> numpy uint32 array with the same bits."""
    return t.detach().cpu().numpy().astype(np.int32, copy=False).view(
        np.uint32)


def _bit_masks(n: int, device) -> tuple:
    """(word index (n,), single-bit int32 mask (n,)) of each vertex."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    mask = torch.bitwise_left_shift(torch.ones_like(idx), idx & 31)
    return idx >> 5, mask.to(torch.int32)


def unpack(words: torch.Tensor, n: int) -> torch.Tensor:
    """(..., W) int32 words -> (..., n) bool."""
    word_idx, mask = _bit_masks(n, words.device)
    w = torch.index_select(words, -1, word_idx)
    return (w & mask) != 0


def pack(bits: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) bool -> (..., W) int32 words."""
    w = n_words(n)
    pad = w * 32 - n
    b = bits.to(torch.int64)
    if pad:
        b = torch.cat([b, b.new_zeros(b.shape[:-1] + (pad,))], dim=-1)
    b = b.reshape(b.shape[:-1] + (w, 32))
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (b << shifts).sum(dim=-1)            # < 2^32, exact in int64
    return narrow(words)


def narrow(words64: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(words64 >= (1 << 31), words64 - (1 << 32),
                       words64).to(torch.int32)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Population count over the trailing word axis: (..., W) -> (...,)
    int64."""
    x = words.to(torch.int64) & MASK32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = (x * 0x01010101) & MASK32
    return (x >> 24).sum(dim=-1)


def get_bit(words: torch.Tensor, i: int) -> torch.Tensor:
    """Test bit i of a (..., W) bitset -> (...,) bool."""
    word = words[..., i >> 5].to(torch.int64) & MASK32
    return ((word >> (i & 31)) & 1) != 0


def eye_words(n: int, w: int, device) -> torch.Tensor:
    """(n, W) identity bitset matrix: row i is {i}."""
    word_idx, mask = _bit_masks(n, device)
    out = torch.zeros((n, w), dtype=torch.int32, device=device)
    out[torch.arange(n, device=device), word_idx] = mask
    return out
