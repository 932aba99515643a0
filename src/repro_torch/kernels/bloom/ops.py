"""Wrapper of the row-order Bloom CUDA kernel (``csrc/bloom.cu``).

``bloom_insert`` is the ``cuda`` implementation of the registry's
``bloom_query_insert`` op (``repro_torch.core.backend``), over a filter
packed 32 bits to an int32 word (``make_filter_words``).  It ports
``repro.kernels.bloom.ops.bloom_insert`` and the Pallas kernel behind it:
rows are inserted in order, so ``was_new[i]`` sees the bits of rows
0..i-1, as ``repro.kernels.bloom.ref.bloom_ref`` does.  The ``torch``
backend's op (``repro_torch.core.bloom.query_and_insert``) queries the
whole batch first; the two differ only when rows of one batch share probe
bits.

With a lane axis (filter ``(L, m_bits / 32)``, states ``(L, B, W)``, valid
``(L, B)``) one call inserts every lane's rows into that lane's own
filter, rows in order within each lane: the multi-lane engine's form.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
``bloom_insert_ref``.  Nothing else falls back: a failed build or launch
raises.  Both update the filter in place and return it.  ``LAUNCHES``
counts wrapper calls that ran the kernel (a memset and three launches
each: count, scatter and resolve), ``LAUNCHES_BY_LANES`` the same calls by
lane count L (1 for the single-lane form).  The kernel's scratch
(``scratch_plan``) is sized from L, B and ``k_hashes``, never from
``m_bits``, and allocated per call.
"""
from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.core import bitset, bloom
from repro_torch.kernels import build

LAUNCHES = 0
LAUNCHES_BY_LANES: collections.Counter = collections.Counter()

# buckets of a lane's claims at most: bloom.cu's kMaxBuckets
BUCKET_LOG = 12
MAX_BUCKETS = 1 << BUCKET_LOG

_c = ctypes.c_void_p
_i = ctypes.c_int
# states, valid, w, n_rows, lanes, m_bits, k_hashes, shift, buckets, filt,
# header, rows, claims, was_new, stream
_ARGTYPES = [_c, _c, _i, _i, _i, ctypes.c_uint, _i, _i, _i, _c, _c, _c, _c,
             _c, _c]


class ScratchPlan(NamedTuple):
    """The kernel's geometry and scratch for one call.  Bucket b of a lane
    holds the probe positions [b << shift, (b + 1) << shift); ``buckets``
    of them cover m_bits.  The scratch is int32 words, in this order:
    ``header_words`` (each lane's bucket counts, fills and offsets, room
    for MAX_BUCKETS, and the length of its row list), ``row_words`` (each
    lane's list of the rows that claim, a count of lost claims per row,
    then a claim mask per 32 probes of every row, padded to 8 bytes) and
    ``claim_words`` (an 8-byte (position, row) slot per probe of every
    row)."""
    shift: int
    buckets: int
    header_words: int
    row_words: int
    claim_words: int

    @property
    def nbytes(self) -> int:
        return 4 * (self.header_words + self.row_words + self.claim_words)


def scratch_plan(lanes: int, rows: int, m_bits: int,
                 k_hashes: int) -> ScratchPlan:
    """The bucket geometry for ``m_bits`` and the scratch of a call with
    ``lanes`` lanes of ``rows`` rows probed ``k_hashes`` times; the
    scratch's size depends on lanes, rows and k_hashes only."""
    shift = max(0, (m_bits - 1).bit_length() - BUCKET_LOG)
    header = lanes * (3 * MAX_BUCKETS + 1)
    listed = lanes * rows * (2 + -(-k_hashes // 32))
    return ScratchPlan(shift, -(-m_bits >> shift), header + header % 2,
                       listed + listed % 2, 2 * lanes * rows * k_hashes)


def make_filter_words(m_bits: int, device=None,
                      lanes: Optional[int] = None) -> torch.Tensor:
    """An empty packed filter: (m_bits / 32,) int32 words, or one per lane,
    (lanes, m_bits / 32)."""
    if m_bits % 32:
        raise ValueError(f"a packed filter needs m_bits % 32 == 0 "
                         f"(got {m_bits})")
    lead = () if lanes is None else (lanes,)
    return torch.zeros(lead + (m_bits // 32,), dtype=torch.int32,
                       device=device)


def bloom_insert_ref(filter_words, states, valid, *, m_bits: int,
                     k_hashes: int = bloom.DEFAULT_K):
    """Plain PyTorch version of the kernel, by the kernel's rule: row i
    owns a probe position when it is the first valid row to probe it, and
    is new when it owns a position whose bit was zero before the batch.
    Returns (was_new (B,) bool, filter_words updated in place).  With a
    lane axis each lane is inserted into its own filter on its own."""
    if filter_words.dim() == 2:
        was_new = torch.stack([
            bloom_insert_ref(filter_words[i], states[i], valid[i],
                             m_bits=m_bits, k_hashes=k_hashes)[0]
            for i in range(filter_words.shape[0])])
        return was_new, filter_words
    b = states.shape[0]
    was_new = torch.zeros((b,), dtype=torch.bool, device=states.device)
    rows = valid.nonzero().squeeze(1)
    if rows.numel() == 0:
        return was_new, filter_words
    idx = bloom.probe_indices(states[rows], m_bits, k_hashes)  # (R, k)
    pos = idx.reshape(-1)
    row_of = rows[:, None].expand_as(idx).reshape(-1)
    uniq, inv = torch.unique(pos, return_inverse=True)
    owner = torch.full((uniq.numel(),), b, dtype=torch.int64,
                       device=states.device)
    owner = owner.scatter_reduce(0, inv, row_of, "amin")
    old = filter_words[uniq >> 5].to(torch.int64) & bitset.MASK32
    zero = ((old >> (uniq & 31)) & 1) == 0
    fresh = (zero[inv] & (owner[inv] == row_of)).reshape(idx.shape)
    was_new[rows] = fresh.any(dim=1)
    # distinct positions in one word are distinct bits: their sum is
    # their OR
    words, winv = torch.unique(uniq >> 5, return_inverse=True)
    bits = torch.zeros((words.numel(),), dtype=torch.int64,
                       device=states.device)
    bits.index_add_(0, winv, torch.ones_like(uniq) << (uniq & 31))
    merged = (filter_words[words].to(torch.int64) & bitset.MASK32) | bits
    filter_words[words] = bitset.narrow(merged)
    return was_new, filter_words


def _lib():
    lib = build.library("bloom")
    if lib.bloom_launch.argtypes is None:
        lib.bloom_launch.argtypes = _ARGTYPES
        lib.bloom_launch.restype = ctypes.c_int
    return lib


def bloom_insert(filter_words, states, valid, *, m_bits: int,
                 k_hashes: int = bloom.DEFAULT_K):
    """Insert the valid rows of states (B, W) int32 into the packed filter
    in row order.  Returns (was_new (B,) bool, filter_words), the filter
    updated in place.  With a lane axis (filter (L, m_bits / 32), states
    (L, B, W), valid (L, B)) every lane goes into its own filter in the
    same launches."""
    global LAUNCHES
    lanes = filter_words.dim() == 2
    lead = tuple(filter_words.shape[:1]) if lanes else ()
    if states.dim() != len(lead) + 2 or m_bits % 32 \
            or states.shape[:-2] != lead \
            or valid.shape != states.shape[:-1] \
            or filter_words.shape != lead + (m_bits // 32,):
        raise ValueError(
            f"bloom_insert: expected filter_words ([L,] {m_bits // 32}) "
            f"with m_bits % 32 == 0, states ([L,] B, W), valid ([L,] B); "
            f"got m_bits={m_bits}, {tuple(filter_words.shape)}, "
            f"{tuple(states.shape)}, {tuple(valid.shape)}")
    build.check_operands("bloom_insert", states.device,
                         filter_words=(filter_words, torch.int32),
                         states=(states, torch.int32),
                         valid=(valid, torch.bool))
    if states.device.type == "cpu":
        return bloom_insert_ref(filter_words, states, valid, m_bits=m_bits,
                                k_hashes=k_hashes)
    build.require_cuda("bloom_insert", states)
    nl = lead[0] if lanes else 1
    b, w = states.shape[-2:]
    was_new = torch.empty(valid.shape, dtype=torch.bool,
                          device=states.device)
    if b == 0 or nl == 0:
        return was_new, filter_words
    plan = scratch_plan(nl, b, m_bits, k_hashes)
    scratch = torch.empty((plan.nbytes // 4,), dtype=torch.int32,
                          device=states.device)
    header = scratch.data_ptr()
    rows = header + 4 * plan.header_words
    with torch.cuda.device(states.device):
        err = _lib().bloom_launch(
            states.data_ptr(), valid.data_ptr(), w, b, nl, m_bits, k_hashes,
            plan.shift, plan.buckets, filter_words.data_ptr(), header, rows,
            rows + 4 * plan.row_words, was_new.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check_launch("bloom", err,
                       f"W={w}, B={b}, L={nl}, m_bits={m_bits}")
    LAUNCHES += 1
    LAUNCHES_BY_LANES[nl] += 1
    return was_new, filter_words
