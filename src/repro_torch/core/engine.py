"""The wavefront engine: levels of the Held-Karp DP over a fixed frontier.

Ports ``repro.core.engine``.  The reference runs the level and chunk loops
inside one ``lax.while_loop`` program; PyTorch runs eagerly, so here both
loops run on the host and read the frontier's ``count`` once per level
(one device sync per level).  Chunks launch without syncing: the append
offset and drop counter stay on the device.

The chunk geometry is the reference's exactly, because which rows survive
an overflow depends on it:

  * a level runs in ``block``-row chunks, or in one ``SMALL_BLOCK``-row
    chunk when its whole frontier fits there;
  * children of a chunk are sorted, deduped and appended in sorted order;
    rows past ``cap`` are dropped and counted;
  * a level that spanned several chunks (``count > blk``) gets one
    cross-chunk sort-dedup over the whole buffer.

``mode="bloom"`` is the paper's dedup: each level gets a fresh filter
(``bloom_make_filter``), every chunk's sorted-unique children are queried
and inserted (``bloom_query_insert``) before they are appended, and the
cross-chunk sort-dedup is skipped.

``fused_decide_launch`` / ``DispatchHandle.result()`` keep the reference's
launch/result split; ``result()`` is the one copy of the verdict to the
host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from . import backend as backend_lib
from . import bloom, dedup
from . import frontier as frontier_lib
from . import telemetry

# below this frontier size a level runs as one narrow chunk instead of a
# full-``block``-wide one
SMALL_BLOCK = 128

# the solver's default Bloom filter size in bits (``solve(m_bits=...)``)
DEFAULT_M_BITS = 1 << 24


@dataclasses.dataclass
class DispatchHandle:
    """A launched decide whose copy to the host is deferred.

    ``result()`` copies the held tensors to the host once (counted as one
    ``host_syncs`` on the tracker), converts them through ``finalize`` and
    caches the value.  ``ready()`` polls without blocking."""
    arrays: Any                      # tuple of in-flight tensors / ints
    finalize: Callable[[Any], Any]   # host values -> caller-shaped result
    tracker: Any = None              # telemetry scope (None = process root)
    event: Optional[torch.cuda.Event] = None
    _result: Any = None
    _done: bool = False
    _t0: float = dataclasses.field(default_factory=time.perf_counter)

    def ready(self) -> bool:
        """Has the device finished?  Never blocks."""
        return self._done or self.event is None or self.event.query()

    def result(self):
        """Block for the verdict: one copy to the host, then cached."""
        if not self._done:
            host = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                         for a in self.arrays)
            tr = telemetry.get(self.tracker)
            tr.count(host_syncs=1)
            tr.timing("dispatch_wall_s", time.perf_counter() - self._t0)
            self._result = self.finalize(host)
            self.arrays = None
            self._done = True
        return self._result

    def discard(self) -> None:
        """Abandon the dispatch without reading it; ``result()`` then
        returns ``None``."""
        if not self._done:
            self.arrays = None
            self._result = None
            self._done = True


def validate_geometry(cap: int, block: int, *, adaptive: bool = False) -> int:
    """Fail fast on buffer geometry the chunk slicer cannot walk cleanly.

    ``adaptive=True`` checks every block size the host loop's per-level
    adaptation (``max(32, min(block, 2^j))``) can pick.  Returns the
    (possibly clamped) block.
    """
    block = min(block, cap)
    sizes = ({max(32, min(block, 1 << j)) for j in range(26)}
             if adaptive else {block})
    bad = sorted(b for b in sizes if cap % b)
    if bad:
        raise ValueError(
            f"block ({bad[0]}{' via adaptive sizing' if adaptive else ''}) "
            f"must divide cap ({cap}): the chunk slicer walks the buffer "
            "in block strides. Use a power-of-two cap >= block")
    return block


def new_out(cap: int, w: int, device) -> torch.Tensor:
    """A level's append buffer: ``cap`` rows plus the drop slot."""
    return torch.zeros((cap + 1, w), dtype=torch.int32, device=device)


def expand_chunk(adj, states_chunk, chunk_valid, k, out, ocount, dropped,
                 filt, allowed, *, n, cap, block, mode, use_mmw, m_bits,
                 k_hashes, schedule, backend, use_simplicial=False):
    """Expand one chunk of states and append its deduped children to
    ``out`` (a ``new_out`` buffer).

    ``ocount`` and ``dropped`` are 0-d device tensors; ``filt`` is the
    level's Bloom filter (unused in sort mode).  Returns the updated
    (out, ocount, dropped, filt) without a host sync."""
    w = adj.shape[-1]
    children, feas = backend_lib.get_op("wavefront_expand", backend)(
        adj, states_chunk, chunk_valid, k, allowed, n=n, schedule=schedule,
        use_mmw=use_mmw, use_simplicial=use_simplicial)
    flat = children.reshape(block * n, w)
    fmask = feas.reshape(block * n)
    skeys, keep = backend_lib.get_op("sort_dedup", backend)(flat, fmask)
    if mode == "bloom":
        keep, filt = backend_lib.get_op("bloom_query_insert", backend)(
            filt, skeys, keep, m_bits=m_bits, k_hashes=k_hashes)
    _, written, drop = dedup.compact(skeys, keep, cap, offset=ocount,
                                     out=out)
    return out, ocount + written, dropped + drop, filt


def chunk_sweep(adj, allowed, k, states, count: int, blk, *, n, cap, mode,
                use_mmw, m_bits, k_hashes, schedule, backend,
                use_simplicial):
    """Expand ``count`` rows of ``states`` in ``blk``-row chunks.

    Returns (out (cap, W), ocount, dropped) with the counts as 0-d
    tensors."""
    w = adj.shape[-1]
    device = adj.device
    out = new_out(cap, w, device)
    ocount = torch.zeros((), dtype=torch.int64, device=device)
    dropped = torch.zeros((), dtype=torch.int64, device=device)
    filt = None
    if mode == "bloom":
        filt = backend_lib.get_op("bloom_make_filter", backend)(
            m_bits, device=device)
    rows = torch.arange(blk, dtype=torch.int64, device=device)
    for lo in range(0, count, blk):
        out, ocount, dropped, filt = expand_chunk(
            adj, states[lo:lo + blk], (rows + lo) < count, k, out, ocount,
            dropped, filt, allowed, n=n, cap=cap, block=blk, mode=mode,
            use_mmw=use_mmw, m_bits=m_bits, k_hashes=k_hashes,
            schedule=schedule, backend=backend,
            use_simplicial=use_simplicial)
    out = out[:cap]
    if mode == "sort" and count > blk:
        # cross-chunk exact dedup, only when the level spanned several
        # chunks (single-chunk output is already sorted-unique)
        valid = torch.arange(cap, device=device) < ocount
        out, ocount, drop2 = dedup.dedup_compact(out, valid, cap)
        dropped = dropped + drop2
    return out, ocount, dropped


def _level_step(adj, allowed, k, fr, count: int, *, n, cap, block, **kw):
    """One wavefront level over the ``count`` live rows of ``fr``."""
    small = min(block, SMALL_BLOCK)
    blk = small if (small != block and count <= small) else block
    out, ocount, dropped = chunk_sweep(adj, allowed, k, fr.states, count,
                                       blk, n=n, cap=cap, **kw)
    return frontier_lib.Frontier(out, ocount.to(torch.int32),
                                 dropped.to(torch.int32))


def decide_loop(adj, allowed, k, target, fr, *, n, cap, block, mode,
                use_mmw, m_bits, k_hashes, schedule, backend,
                use_simplicial):
    """Run up to ``target`` wavefront levels; stop early on emptiness.

    Returns (frontier, levels_run, expanded, dropped_total); the last is a
    0-d tensor.  Reads the frontier's count once per level."""
    level, expanded = 0, 0
    dropped = torch.zeros((), dtype=torch.int32, device=adj.device)
    count = int(fr.count)
    while level < target and count > 0:
        expanded += count
        fr = _level_step(adj, allowed, k, fr, count, n=n, cap=cap,
                         block=block, mode=mode, use_mmw=use_mmw,
                         m_bits=m_bits, k_hashes=k_hashes,
                         schedule=schedule, backend=backend,
                         use_simplicial=use_simplicial)
        dropped = dropped + fr.dropped
        count = int(fr.count)
        level += 1
    return fr, level, expanded, dropped


def fused_decide_launch(adj_dev, allowed_dev, k: int, target, *, n, cap,
                        block, mode="sort", use_mmw=False,
                        m_bits=DEFAULT_M_BITS, k_hashes=bloom.DEFAULT_K,
                        schedule="doubling", backend="torch",
                        use_simplicial=False, fr=None, max_levels=None,
                        tracker=None) -> DispatchHandle:
    """Run one decide; return its ``DispatchHandle``.

    ``handle.result()`` yields ``(feasible, inexact, expanded,
    frontier_host)``, where ``frontier_host`` holds the final states on
    the CPU and the run's total drop count."""
    device = adj_dev.device
    backend_lib.validate(backend, mode=mode, schedule=schedule,
                         use_mmw=use_mmw, use_simplicial=use_simplicial,
                         m_bits=m_bits, device=device)
    block = validate_geometry(cap, block)
    w = adj_dev.shape[-1]
    if fr is None:
        fr = frontier_lib.empty_frontier(cap, w, device)
    levels = target if max_levels is None else min(target, max_levels)

    fr, _level, expanded, dropped = decide_loop(
        adj_dev, allowed_dev, int(k), levels, fr, n=n, cap=cap, block=block,
        mode=mode, use_mmw=use_mmw, m_bits=m_bits, k_hashes=k_hashes,
        schedule=schedule, backend=backend, use_simplicial=use_simplicial)
    tr = telemetry.get(tracker)
    tr.count(dispatches=1)
    event = None
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record()

    def finalize(host):
        states_h, count_h, expanded_h, dropped_h = host
        fr_host = frontier_lib.Frontier(states_h, count_h, dropped_h)
        return (int(count_h) > 0, int(dropped_h) > 0, int(expanded_h),
                fr_host)

    return DispatchHandle((fr.states, fr.count, expanded, dropped),
                          finalize, tracker=tr, event=event)


def fused_decide(adj_dev, allowed_dev, k: int, target, *, n, cap, block,
                 mode="sort", use_mmw=False, m_bits=DEFAULT_M_BITS,
                 k_hashes=bloom.DEFAULT_K, schedule="doubling",
                 backend="torch", use_simplicial=False, fr=None,
                 max_levels=None, tracker=None):
    """Blocking form of ``fused_decide_launch``: launch, then ``result()``.

    ``fr`` seeds the frontier (defaults to the DP root {∅}); ``max_levels``
    truncates the run (the parity tests compare frontiers level by level).
    Returns (feasible, inexact, expanded, frontier_host)."""
    return fused_decide_launch(
        adj_dev, allowed_dev, k, target, n=n, cap=cap, block=block,
        mode=mode, use_mmw=use_mmw, m_bits=m_bits, k_hashes=k_hashes,
        schedule=schedule, backend=backend, use_simplicial=use_simplicial,
        fr=fr, max_levels=max_levels, tracker=tracker).result()
