"""The wavefront engine: levels of the Held-Karp DP over a fixed frontier.

Ports ``repro.core.engine`` together with its lane axis (the reference
vmaps ``decide_loop`` in ``repro.core.batch``).  The reference runs the
level and chunk loops inside one ``lax.while_loop`` program; PyTorch runs
eagerly, so here both loops run on the host.  ``decide_loop`` steps the
lanes of a lane-batched frontier (one lane for ``fused_decide``), each
with its own adjacency, allowed mask, k, target and frontier, and reads
the ``(L,)`` counts once per level (one device sync per level).  Chunks
launch without syncing: append offsets and drop counters stay on the
device.

The chunk geometry is each lane's own, as in the reference, because which
rows survive an overflow depends on it:

  * a lane's level runs in ``block``-row chunks, or in one
    ``SMALL_BLOCK``-row chunk when its whole frontier fits there;
  * children of a chunk are sorted, deduped and appended in sorted order;
    rows past ``cap`` are dropped and counted;
  * a level that spanned several chunks (``count > blk``) gets one
    cross-chunk sort-dedup over the whole buffer.

Chunk j of every live lane goes through one ``wavefront_expand``, one
sort and one Bloom call.  When some lane runs ``block``-row chunks, a lane
whose frontier fits in ``SMALL_BLOCK`` rows rides in the same wide tile,
its rows past its count invalid; invalid rows sort after every valid row
and are never kept, so the lane's appended rows, drops and Bloom insert
order are those of its own narrow chunk.  A lane that has finished (its
target reached or its frontier empty) keeps its frontier as it was and
leaves the kernels' grids.

``shard_sweep`` is the sharded engine's local step (``core.shard``): every
shard's rows in full ``block``-row chunks, the shards as the kernels' lane
axis, with no narrow branch and no cross-chunk dedup, as the reference
sweeps its shards.

``mode="bloom"`` is the paper's dedup: each level gets a fresh filter per
lane (``bloom_make_filter``), every chunk's sorted-unique children are
queried and inserted (``bloom_query_insert``) before they are appended,
and the cross-chunk sort-dedup is skipped.

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

# Accounting lives in ``core.telemetry``; ``COUNTERS`` survives as the
# reference's deprecated read-only view over the root tracker.
COUNTERS = telemetry.COUNTERS


def reset_counters():
    """Deprecated: zero the process-root tracker (``telemetry.reset``)."""
    telemetry.reset()


def count(dispatches: int = 0, host_syncs: int = 0, **extra: int):
    """Deprecated shim: count on the process-root tracker.  Library code
    threads an explicit ``tracker=`` instead."""
    kw = dict(extra)
    if dispatches:
        kw["dispatches"] = dispatches
    if host_syncs:
        kw["host_syncs"] = host_syncs
    telemetry.root().count(**kw)


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


def new_out(cap: int, w: int, device, lanes: Optional[int] = None):
    """A level's append buffer: ``cap`` rows plus the drop slot (one per
    lane with ``lanes``)."""
    lead = () if lanes is None else (lanes,)
    return torch.zeros(lead + (cap + 1, w), dtype=torch.int32,
                       device=device)


def expand_chunk(adj, states_chunk, chunk_valid, k, out, ocount, dropped,
                 filt, allowed, *, n, cap, block, mode, use_mmw, m_bits,
                 k_hashes, schedule, backend, use_simplicial=False):
    """Expand one chunk of states and append its deduped children to
    ``out`` (a ``new_out`` buffer).

    ``ocount`` and ``dropped`` are 0-d device tensors; ``filt`` is the
    level's Bloom filter (unused in sort mode).  Returns the updated
    (out, ocount, dropped, filt) without a host sync.  In the lane form
    every operand has a leading lane axis, ``k`` is an (L,) int32 tensor
    and the counts are (L,)."""
    w = adj.shape[-1]
    lead = chunk_valid.shape[:-1]          # (L,) in the lane form
    children, feas = backend_lib.get_op("wavefront_expand", backend)(
        adj, states_chunk, chunk_valid, k, allowed, n=n, schedule=schedule,
        use_mmw=use_mmw, use_simplicial=use_simplicial)
    flat = children.reshape(lead + (block * n, w))
    fmask = feas.reshape(lead + (block * n,))
    skeys, keep = backend_lib.get_op("sort_dedup", backend)(flat, fmask)
    if mode == "bloom":
        keep, filt = backend_lib.get_op("bloom_query_insert", backend)(
            filt, skeys, keep, m_bits=m_bits, k_hashes=k_hashes)
    _, written, drop = dedup.compact(skeys, keep, cap, offset=ocount,
                                     out=out)
    return out, ocount + written, dropped + drop, filt


def _level_step(adj, allowed, k, fr, counts, live, *, n, cap, block,
                mode, use_mmw, m_bits, k_hashes, schedule, backend,
                use_simplicial):
    """One wavefront level of the lanes in ``live``.

    ``counts`` and ``live`` are host lists (the level's one read of the
    counts).  Only the live lanes enter the kernels: when some lane has
    finished, the others' operands are gathered first.  Returns
    (frontier, dropped (L,) int64 of this level)."""
    nl, _, w = fr.states.shape
    device = adj.device
    on = [i for i in range(nl) if live[i]]
    sel = None
    if len(on) < nl:
        sel = torch.tensor(on, dtype=torch.int64, device=device)
        adj, allowed, k = adj[sel], allowed[sel], k[sel]
    states = fr.states if sel is None else fr.states[sel]
    counts = [counts[i] for i in on]
    count_dev = (fr.count if sel is None else fr.count[sel]).to(torch.int64)
    small = min(block, SMALL_BLOCK)
    # each lane's own chunk width
    blks = [small if (small != block and c <= small) else block
            for c in counts]
    tile = max(blks)
    n_chunks = max(-(-c // tile) for c in counts)
    out = new_out(cap, w, device, lanes=len(on))
    ocount = torch.zeros((len(on),), dtype=torch.int64, device=device)
    dropped = torch.zeros((len(on),), dtype=torch.int64, device=device)
    filt = None
    if mode == "bloom":
        filt = backend_lib.get_op("bloom_make_filter", backend)(
            m_bits, device=device, lanes=len(on))
    rows = torch.arange(tile, dtype=torch.int64, device=device)
    for c in range(n_chunks):
        lo = c * tile
        out, ocount, dropped, filt = expand_chunk(
            adj, states[:, lo:lo + tile],
            (rows + lo)[None] < count_dev[:, None], k, out, ocount,
            dropped, filt, allowed, n=n, cap=cap, block=tile, mode=mode,
            use_mmw=use_mmw, m_bits=m_bits, k_hashes=k_hashes,
            schedule=schedule, backend=backend,
            use_simplicial=use_simplicial)
    out = out[:, :cap]
    # the cross-chunk dedup, for the lanes whose level spanned several of
    # their own chunks
    need = [i for i, (c, b) in enumerate(zip(counts, blks)) if c > b]
    if mode == "sort" and need:
        part = torch.tensor(need, dtype=torch.int64, device=device)
        valid = torch.arange(cap, device=device)[None] < ocount[part, None]
        buf, cnt, drop2 = dedup.dedup_compact(out[part], valid, cap)
        out[part] = buf
        ocount[part] = cnt
        dropped[part] += drop2
    if sel is None:
        return frontier_lib.Frontier(out, ocount.to(torch.int32),
                                     dropped.to(torch.int32)), dropped
    # finished lanes keep their frontier
    new = frontier_lib.Frontier(fr.states.clone(), fr.count.clone(),
                                fr.dropped.clone())
    new.states[sel] = out
    new.count[sel] = ocount.to(torch.int32)
    new.dropped[sel] = dropped.to(torch.int32)
    all_dropped = torch.zeros((nl,), dtype=torch.int64, device=device)
    all_dropped[sel] = dropped
    return new, all_dropped


def shard_sweep(adj, allowed, k, states, count, counts, *, n, cap, block,
                use_mmw, schedule, backend, use_simplicial):
    """Expand every shard's rows in ``block``-row chunks: the sharded
    engine's local step (``core.shard``), the reference's
    ``chunk_sweep(..., mode="sort", max_chunks=cap // block,
    cross_dedup=False)`` under ``vmap``.

    Every chunk is a full ``block`` wide (no ``SMALL_BLOCK`` branch),
    children are deduped within their chunk only, and nothing dedups
    across chunks: that happens at the owner after routing.  Chunk j of
    every shard goes through one ``wavefront_expand`` (the shards are its
    lane axis) and one sort; a shard with fewer chunks rides with invalid
    rows.  adj (S, n, W), allowed (S, W), k (S,) int32, states (S, cap,
    W), ``count`` the (S,) device counts and ``counts`` the same on the
    host.  Returns (out (S, cap, W), ocount (S,), dropped (S,)), the
    counts as int64 device tensors."""
    s, _, w = states.shape
    device = states.device
    count_dev = count.to(torch.int64)
    out = new_out(cap, w, device, lanes=s)
    ocount = torch.zeros((s,), dtype=torch.int64, device=device)
    dropped = torch.zeros((s,), dtype=torch.int64, device=device)
    rows = torch.arange(block, dtype=torch.int64, device=device)
    for c in range(-(-max(counts) // block)):
        lo = c * block
        out, ocount, dropped, _ = expand_chunk(
            adj, states[:, lo:lo + block],
            (rows + lo)[None] < count_dev[:, None], k, out, ocount,
            dropped, None, allowed, n=n, cap=cap, block=block, mode="sort",
            use_mmw=use_mmw, m_bits=1, k_hashes=1, schedule=schedule,
            backend=backend, use_simplicial=use_simplicial)
    return out[:, :cap], ocount, dropped


def decide_loop(adj, allowed, k, targets, fr, *, n, cap, block, mode,
                use_mmw, m_bits, k_hashes, schedule, backend,
                use_simplicial):
    """Run every lane of a lane-batched frontier up to its target level;
    a lane stops early on emptiness, as it would alone.

    adj (L, n, W), allowed (L, W), k an (L,) int32 tensor on the device,
    ``targets`` a host list of each lane's level count, ``fr`` a
    ``frontier.lane_frontiers`` carry.  Each level reads the (L,) counts
    once.  Returns (frontier, levels_run, expanded, dropped_total), the
    middle two host lists and the last an (L,) int32 tensor."""
    nl = len(targets)
    levels, expanded = [0] * nl, [0] * nl
    dropped = torch.zeros((nl,), dtype=torch.int32, device=adj.device)
    while True:
        counts = fr.count.tolist()
        live = [levels[i] < targets[i] and counts[i] > 0
                for i in range(nl)]
        if not any(live):
            return fr, levels, expanded, dropped
        for i in range(nl):
            if live[i]:
                expanded[i] += counts[i]
                levels[i] += 1
        fr, drop = _level_step(
            adj, allowed, k, fr, counts, live, n=n, cap=cap, block=block,
            mode=mode, use_mmw=use_mmw, m_bits=m_bits, k_hashes=k_hashes,
            schedule=schedule, backend=backend,
            use_simplicial=use_simplicial)
        dropped = dropped + drop.to(torch.int32)


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

    one = frontier_lib.Frontier(fr.states[None], fr.count.reshape(1),
                                fr.dropped.reshape(1))
    one, _level, expanded, dropped = decide_loop(
        adj_dev[None], allowed_dev[None],
        torch.tensor([int(k)], dtype=torch.int32, device=device), [levels],
        one, n=n, cap=cap, block=block, mode=mode, use_mmw=use_mmw,
        m_bits=m_bits, k_hashes=k_hashes, schedule=schedule,
        backend=backend, use_simplicial=use_simplicial)
    fr = frontier_lib.Frontier(one.states[0], one.count[0], one.dropped[0])
    expanded, dropped = expanded[0], dropped[0]
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
