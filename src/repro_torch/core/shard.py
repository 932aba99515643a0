"""Intra-request scale-out: one instance's frontier across S shards
(``repro.core.shard``).

One decide rung (is tw(g) <= k?) normally runs on a single frontier
buffer.  This module splits that frontier across ``S`` shards on one
device; each level is

    local expand of every shard  ->  ownership route  ->  owner dedup
    ->  (Bloom probe per shard)  ->  threshold donation

  * **Expansion** (``engine.shard_sweep``): each shard expands its own
    rows in full ``block``-row chunks with intra-chunk dedup only.  The
    shards are the lane axis of the wavefront kernel, so chunk j of
    every shard is one launch with the same adjacency, allowed mask and
    ``k`` in every lane.
  * **Dedup** by single-writer ownership: every candidate state goes to
    the owner shard ``murmur3(state, SEED1) % S``, which runs the exact
    sort-dedup.  Under ``mode="bloom"`` each owner also probes its own
    Bloom filter, one writer per filter; the S filters go through one
    ``bloom_query_insert`` call per level and, unlike the single-lane
    engine's per-level filters, live for the whole rung.
  * **Donation** rebalances the shards: when the largest post-dedup
    occupancy exceeds ``donate_ratio`` times the mean, the rows are
    re-split evenly (``_repack``).  Only already-owned parent rows move,
    so donation never duplicates or loses a state.

The reference runs the level loop inside one ``lax.while_loop``; here it
runs on the host and reads the post-dedup ``(S,)`` counts once per
level.  The donation trigger is decided from that same read (the plan
is arithmetic on the counts), so a level makes one host read in all.

Sort mode without overflow gives the unsharded verdict, ``expanded`` and
``per_k`` bit for bit; with overflow the local, routing and owner drops
are the reference's sharded run's (``tests/test_torch_shard.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import backend as backend_lib
from . import bitset, bloom, dedup
from . import engine as engine_lib
from . import frontier as frontier_lib
from . import telemetry
from .graph import Graph

# donate when max shard occupancy exceeds ratio x mean occupancy; <= 1.0
# rebalances every level
DEFAULT_DONATE_RATIO = 1.5


# --------------------------------------------------------------- ownership

def route_states(rows: torch.Tensor, valid: torch.Tensor, nshards: int,
                 cap_recv: int):
    """Partition the valid rows (M, W) to their owner shard (murmur3 of the
    words as unsigned, mod S).

    Returns (recv (S, cap_recv, W), counts (S,), dropped): rows are sorted
    by (owner, words) first, so each owner's bucket arrives sorted; an
    owner receives at most ``cap_recv`` rows and the rest are dropped and
    counted.  Invalid rows get owner S and sort last."""
    m, w = rows.shape
    device = rows.device
    owner = bloom.murmur3_words(rows, bloom.SEED1) % nshards
    owner = torch.where(valid, owner, torch.full_like(owner, nshards))
    perm = dedup.sort_perm(rows, major=owner)
    owner_s, rows_s = owner[perm], rows[perm]
    # the owner is the major key, so each owner's rows are one run
    ids = torch.arange(nshards, device=device)
    starts = torch.searchsorted(owner_s, ids)
    counts = torch.searchsorted(owner_s, ids, right=True) - starts
    safe = torch.clamp(owner_s, max=nshards - 1)
    pos = torch.arange(m, device=device) - starts[safe]
    ok = (owner_s < nshards) & (pos < cap_recv)
    dest = torch.where(ok, safe * cap_recv + pos,
                       torch.full_like(pos, nshards * cap_recv))
    recv = torch.zeros((nshards * cap_recv + 1, w), dtype=rows.dtype,
                       device=device)                # last row: drop slot
    recv.index_put_((dest,), rows_s)
    rcounts = torch.clamp(counts, max=cap_recv)
    return (recv[:-1].reshape(nshards, cap_recv, w), rcounts,
            (counts - rcounts).sum())


# ---------------------------------------------------------------- donation

def donation_plan(counts, ratio: float):
    """Water-filling donation targets for per-shard occupancies (host ints:
    a list, a numpy array or a CPU tensor).

    Returns (targets (S,) int32, triggered, moved): targets are ``total //
    S`` (+1 for the first ``total % S`` shards), so they sum to the total
    and no row is dropped; ``triggered`` is ``max(counts) * S > ratio *
    total`` in float32, as the reference computes it; ``moved`` counts the
    rows that leave their shard."""
    c = np.asarray(counts, dtype=np.int64)
    s = c.shape[0]
    total = int(c.sum())
    base, rem = divmod(total, s)
    targets = (base + (np.arange(s) < rem)).astype(np.int32)
    trig = total > 0 and bool(np.float32(c.max()) * np.float32(s)
                              > np.float32(ratio) * np.float32(total))
    moved = int(np.maximum(c - targets, 0).sum())
    return targets, trig, moved


def _repack(states: torch.Tensor, counts: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    """Redistribute rows so shard d holds ``targets[d]`` rows: concatenate
    every shard's live rows in shard order and re-split at the target
    boundaries (one scatter).  Lossless: ``sum(targets) == sum(counts)``
    and every target fits in ``cap``."""
    s, cap, w = states.shape
    device = states.device
    counts = counts.to(torch.int64)
    targets = targets.to(torch.int64)
    flat = states.reshape(s * cap, w)
    valid = (torch.arange(cap, device=device)[None]
             < counts[:, None]).reshape(-1)
    rank = torch.cumsum(valid.to(torch.int64), 0) - 1
    ends = torch.cumsum(targets, 0)
    shard_of = torch.searchsorted(ends, rank, right=True)
    starts = ends - targets
    dest = shard_of * cap + (rank - starts[torch.clamp(shard_of,
                                                       max=s - 1)])
    dest = torch.where(valid & (shard_of < s), dest,
                       torch.full_like(dest, s * cap))
    out = torch.zeros((s * cap + 1, w), dtype=states.dtype, device=device)
    out.index_put_((dest,), flat)
    return out[:-1].reshape(s, cap, w)


# ----------------------------------------------------------- sharded decide

def sharded_decide_loop(adj, allowed, k: int, target: int, fr, *, shards,
                        n, cap, block, mode, use_mmw, m_bits, k_hashes,
                        schedule, backend, use_simplicial, donate_ratio):
    """Run up to ``target`` levels with the frontier split across shards;
    stop early on emptiness.  ``adj`` (n, W) and ``allowed`` (W,) are the
    rung's, ``fr`` a ``frontier.shard_frontiers`` carry.

    Returns (counts, levels, expanded, dropped, stats): the final (S,)
    counts as a host list, host ints, the total drops as a device
    tensor, and ``stats = [donation_events, donated_rows,
    idle_shard_steps, peak_shard_occupancy]`` as host ints."""
    s = shards
    device = adj.device
    w = adj.shape[-1]
    # the wavefront kernel's lane form: every shard a lane of the rung
    adj_s = adj.expand(s, -1, -1).contiguous()
    allowed_s = allowed.expand(s, -1).contiguous()
    k_s = torch.full((s,), int(k), dtype=torch.int32, device=device)
    rows = torch.arange(cap, device=device)
    filts = None
    if mode == "bloom":
        # one filter per shard, kept for the whole rung
        filts = backend_lib.get_op("bloom_make_filter", backend)(
            m_bits, device=device, lanes=s)
        query_insert = backend_lib.get_op("bloom_query_insert", backend)
    states, count = fr.states, fr.count
    counts = count.tolist()
    level = expanded = 0
    dropped = torch.zeros((), dtype=torch.int64, device=device)
    stats = [0, 0, 0, 0]
    while level < target and sum(counts) > 0:
        expanded += sum(counts)
        stats[2] += counts.count(0)
        stats[3] = max(stats[3], max(counts))
        out, ocnt, drop_local = engine_lib.shard_sweep(
            adj_s, allowed_s, k_s, states, count, counts, n=n, cap=cap,
            block=block, use_mmw=use_mmw, schedule=schedule,
            backend=backend, use_simplicial=use_simplicial)
        valid = (rows[None] < ocnt[:, None]).reshape(-1)
        recv, rcounts, drop_route = route_states(out.reshape(s * cap, w),
                                                 valid, s, cap)
        buf, cnts, drop_own = dedup.dedup_compact(
            recv, rows[None] < rcounts[:, None], cap)
        if mode == "bloom":
            buf = buf.contiguous()
            keep, filts = query_insert(filts, buf, rows[None] < cnts[:, None],
                                       m_bits=m_bits, k_hashes=k_hashes)
            buf, cnts, _ = dedup.compact(buf, keep, cap)
        dropped = dropped + drop_local.sum() + drop_route + drop_own.sum()
        counts = cnts.tolist()                # the level's one host read
        targets, trig, moved = donation_plan(counts, donate_ratio)
        if trig:
            tdev = torch.from_numpy(targets).to(device)
            buf, cnts = _repack(buf, cnts, tdev), tdev
            counts = targets.tolist()
            stats[0] += 1
            stats[1] += moved
        states, count = buf, cnts.to(torch.int32)
        level += 1
    return counts, level, expanded, dropped, stats


# ------------------------------------------------------------ host wrappers

def _record_stats(stats_h, tracker=None) -> None:
    ev, moved, idle, peak = (int(x) for x in stats_h)
    tr = telemetry.get(tracker)
    tr.count(shard_donations=ev, shard_donated_rows=moved,
             shard_idle_steps=idle)
    tr.gauge_max("shard_peak_occupancy", peak)


def decide_sharded_async(g: Graph, k: int, clique=(), *, shards: int,
                         mesh=None, cap: Optional[int] = None,
                         block: int = 1 << 11, mode: str = "sort",
                         use_mmw: bool = False,
                         m_bits: int = engine_lib.DEFAULT_M_BITS,
                         k_hashes: int = bloom.DEFAULT_K,
                         schedule: Optional[str] = None,
                         backend: Optional[str] = None,
                         use_simplicial: bool = False,
                         donate_ratio: Optional[float] = None,
                         n_pad: Optional[int] = None,
                         budget_bytes=None,
                         tracker=None, device=None
                         ) -> engine_lib.DispatchHandle:
    """Run one sharded decide rung; return its ``DispatchHandle``.

    ``handle.result()`` yields a one-element list holding a
    ``batch.LaneResult``, the shape one lane of the multi-lane engine
    gives.  ``cap`` is the per-shard capacity; ``cap=None`` plans
    ``batch.plan_capacity(n, W, lanes=shards, block=block)``.  ``n_pad``
    embeds the graph in a larger vertex space (the multi-lane padding).
    Runs on ``device`` (default ``cuda``) with ``backend`` (default
    ``cuda`` on a card, ``torch`` elsewhere).  A ``mesh`` of more than
    one device is the distributed solver, which is not ported."""
    from . import batch as batch_lib

    shards = int(shards)
    device = backend_lib.resolve_device(device)
    if backend is None:
        backend = backend_lib.default_backend(device)
    if schedule is None:
        schedule = "doubling"
    backend_lib.validate(backend, mode=mode, schedule=schedule,
                         use_mmw=use_mmw, use_simplicial=use_simplicial,
                         m_bits=m_bits, shards=shards, device=device)
    if budget_bytes == "auto":
        budget_bytes = backend_lib.device_memory_budget(device=device)
    ratio = DEFAULT_DONATE_RATIO if donate_ratio is None \
        else float(donate_ratio)

    n = g.n
    target = n - max(k + 1, len(clique))
    if target <= 0:
        res = [batch_lib.LaneResult(True, False, 0)]
        return engine_lib.DispatchHandle((), lambda host: res,
                                         _result=res, _done=True)
    # a mesh: an object with a ``devices`` array, a sequence of devices or
    # one device
    if mesh is not None and np.asarray(getattr(mesh, "devices", mesh),
                                       dtype=object).size > 1:
        raise backend_lib.BackendCapabilityError(
            "a sharded rung on a mesh of several devices is the "
            "distributed solver, which is not ported (ROADMAP A11)")

    n_static = n if n_pad is None else int(n_pad)
    if n_static < n:
        raise ValueError(f"n_pad={n_pad} below instance size {n}")
    w = bitset.n_words(n_static)
    if cap is None:
        cap = batch_lib.plan_capacity(n, w, lanes=shards, block=block,
                                      budget_bytes=budget_bytes)
    block = engine_lib.validate_geometry(cap, block)

    adj = np.zeros((n_static, w), dtype=np.uint32)
    p = g.packed()
    adj[:n, :p.shape[1]] = p
    allowed = bitset.np_allowed(n, clique, w)
    fr = frontier_lib.shard_frontiers(shards, cap, w, device)

    counts, _level, expanded, dropped, stats = sharded_decide_loop(
        bitset.to_words(adj, device), bitset.to_words(allowed, device), k,
        target, fr, shards=shards, n=n_static, cap=cap, block=block,
        mode=mode, use_mmw=use_mmw, m_bits=m_bits, k_hashes=k_hashes,
        schedule=schedule, backend=backend, use_simplicial=use_simplicial,
        donate_ratio=ratio)
    tr = telemetry.get(tracker)
    tr.count(dispatches=1)
    event = None
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record()

    def finalize(host):
        (dropped_h,) = host
        _record_stats(stats, tracker=tr)
        return [batch_lib.LaneResult(sum(counts) > 0, int(dropped_h) > 0,
                                     expanded)]

    return engine_lib.DispatchHandle((dropped,), finalize, tracker=tr,
                                     event=event)


def decide_sharded(g: Graph, k: int, clique=(), **kw):
    """Blocking sharded decide: launch and ``result()``; returns the
    rung's ``batch.LaneResult``."""
    return decide_sharded_async(g, k, clique, **kw).result()[0]
