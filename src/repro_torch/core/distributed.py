"""Distributed wavefront solver over ``torch.distributed``
(``repro.core.distributed``).

The reference is one controller over a ``jax`` mesh: ``shard_map`` with
``all_to_all`` and ``all_gather`` over a ``data`` axis.  Here every rank
is a process that owns one device and runs the same program (SPMD per
rank), and the collectives are ``torch.distributed``'s.  Each rank owns
``cap_local`` frontier rows; a level is

    local expand  ->  ownership all_to_all  ->  owner dedup  ->  donation

  * **Expansion** (``_local_expand``): the rank's rows in ``block``-row
    chunks, children deduped within their chunk only:
    ``engine.shard_sweep`` with one lane, the wavefront kernel on a card;
  * **Routing** (``_build_buckets``): every child goes to its owner rank
    ``murmur3(state) % D`` (``shard.route_states``), through one
    ``all_to_all_single`` of the ``(D, cap_send, W)`` buckets and one of
    the ``(D,)`` send counts;
  * **Dedup**: the owner's exact sort-dedup into ``cap_local`` rows.  One
    writer per state, so nothing needs synchronising;
  * **Donation** (``_donate``, when ``donate_ratio`` is not None): every
    rank builds the same transfer matrix from the gathered counts
    (water-filling, ``shard.donation_plan``, each edge clamped to
    ``cap_send``); donors send contiguous tail runs in one more
    ``all_to_all_single`` and receivers append them in sender order;
  * overflow of the local buffer, a send bucket or the owner's buffer
    drops states and marks the run inexact.

The reference runs the level loop inside one ``while_loop``.  Torch has
none, so the loop runs on the host and each level makes one host read:
the all-gathered ``(D, 2)`` table of every rank's post-dedup count and
drops, which every rank needs to agree on when to stop and which the
donation plan needs anyway.  ``engine="fused"`` is that loop;
``engine="host"`` also records per-level telemetry and calls
``checkpoint_cb``.  Both give the same verdicts, ``expanded`` and
``inexact`` as each other and as the reference at the same D.

Checkpoints: after each level the ranks' buffers are gathered, and
``checkpoint_cb`` is called on rank 0 with the reference's dict (level,
k, expanded, inexact, ``states`` (D * cap_local, W) uint32 rank-major,
``counts`` (D,)).  Pass the same ``checkpoint_cb`` on every rank, or on
none: the gather is a collective.  ``resume`` restores such a dict onto
any number of ranks (elastic restart).

Process groups: ``make_solver_mesh`` wraps the calling rank's group;
``launch`` starts D local ranks (``torch.multiprocessing``, spawn) and
returns what each returned.  The group's backend is ``nccl`` when every
rank has a card of its own and ``gloo`` otherwise (several ranks on one
card, or the CPU); the group has a timeout, so a dead rank fails the run
instead of hanging it.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
import traceback
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import backend as backend_lib
from . import bitset, bounds, dedup
from . import engine as engine_lib
from . import preprocess as preprocess_lib
from . import shard as shard_lib
from . import telemetry
from .graph import Graph
from .solver import SolveResult

# a collective that waits longer than this fails its rank
GROUP_TIMEOUT_S = 300


# -------------------------------------------------------------- the mesh

@dataclasses.dataclass(frozen=True)
class SolverMesh:
    """The calling rank's view of the solver's process group."""
    group: Optional[object]    # process group (None: the default group)
    rank: int
    size: int
    device: torch.device       # this rank's device
    backend: str               # "nccl" or "gloo"
    devices: np.ndarray        # (size,) object array: every rank's device


def choose_backend(device, local_ranks: int) -> str:
    """``nccl`` when each of ``local_ranks`` ranks on this host has a card
    of its own, ``gloo`` otherwise (ranks sharing a card, or the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(rank: int, device=None) -> torch.device:
    """Rank ``r``'s device: ``cuda:(r % cards)`` by default or for a bare
    ``"cuda"``, else ``device`` as given.  Raises without a card unless
    the caller asks for the CPU."""
    device = backend_lib.resolve_device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "ranks on the CPU")
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def _init_from_env(device) -> None:
    """Start the default group from the environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun``
    sets them), or as a one-rank group when there is none."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    rank = int(os.environ.get("RANK", "0"))
    backend = choose_backend(rank_device(rank, device), local)
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    if rank == 0:
        print(f"[distributed] {world} rank(s), {local} on this host: "
              f"backend {backend}", flush=True)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)


def make_solver_mesh(group=None, device=None) -> SolverMesh:
    """The calling rank's ``SolverMesh`` over ``group`` (default: the
    default group, started from the environment when it is not yet).

    The rank runs on ``cuda:(rank % cards)`` unless ``device`` names
    another (``"cpu"`` for the tests).  ``mesh.devices`` holds every
    rank's device, gathered once."""
    if not dist.is_initialized():
        _init_from_env(device)
    rank = dist.get_rank(group)
    size = dist.get_world_size(group)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    names = [None] * size
    dist.all_gather_object(names, str(dev), group=group)
    return SolverMesh(group, rank, size, dev, dist.get_backend(group),
                      np.asarray(names, dtype=object))


# what a rank raises when a peer's failure broke the collective it was in
_BROKEN_COLLECTIVE = ("Connection reset", "Connection closed", "gloo",
                      "NCCL", "Broken pipe")


@dataclasses.dataclass(frozen=True)
class _RankFailure:
    """A rank's exception, recorded before the rank exits: its traceback,
    and whether it is a collective that a peer's failure broke."""
    traceback: str
    collective: bool


def _is_broken_collective(exc: BaseException) -> bool:
    return isinstance(exc, getattr(dist, "DistError", ())) or any(
        word in str(exc) for word in _BROKEN_COLLECTIVE)


def _rank_main(rank, world, port, backend, device, timeout_s, fn, args,
               kwargs, results):
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)       # the ranks are the parallelism
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore("127.0.0.1", port, is_master=False,
                          timeout=timeout)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout)
    try:
        results.put((rank, fn(make_solver_mesh(device=dev), *args,
                              **kwargs)))
    except BaseException as exc:
        # recorded before this rank's sockets close, so ahead of any error
        # that its exit causes in a peer
        results.put((rank, _RankFailure(traceback.format_exc(),
                                        _is_broken_collective(exc))))
        raise
    finally:
        dist.destroy_process_group()


def launch(fn, nprocs: int, *args, device="cuda",
           timeout_s: float = GROUP_TIMEOUT_S,
           deadline_s: Optional[float] = None, **kwargs) -> list:
    """Run ``fn(mesh, *args, **kwargs)`` on ``nprocs`` local ranks and
    return the ranks' results in rank order.

    ``fn`` and its arguments are pickled to each rank (a module-level
    function; results are sent back the same way, so return host
    values).  Ranks run on ``device`` (default ``cuda``: rank r on card
    ``r % cards``); the group's backend follows ``choose_backend``.  On
    a card the kernels are built here first, so the ranks only load
    them.  A rank that raises, a collective that waits past
    ``timeout_s`` or a run past ``deadline_s`` stops every rank and
    raises here: a rank's own error ahead of the errors that its failure
    caused in its peers' collectives."""
    device = backend_lib.resolve_device(device)
    rank_device(0, device)                   # raises without a card
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    backend = choose_backend(device, nprocs)
    print(f"[distributed] {nprocs} local rank(s) on {device}: backend "
          f"{backend}", flush=True)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False, timeout=timeout)
    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(
        _rank_main, args=(nprocs, store.port, backend, str(device),
                          timeout_s, fn, args, kwargs, results),
        nprocs=nprocs, join=False, start_method="spawn")
    t_end = None if deadline_s is None else time.monotonic() + deadline_s
    got, failures = {}, []

    def drain():
        while not results.empty():
            rank, value = results.get()
            if isinstance(value, _RankFailure):
                failures.append((rank, value))
            else:
                got[rank] = value

    try:
        while True:
            drain()                         # drain before joining
            if ctx.join(timeout=0.2):
                break
            if t_end is not None and time.monotonic() > t_end:
                raise TimeoutError(f"distributed run of {nprocs} ranks "
                                   f"passed its {deadline_s} s deadline")
    except mp.ProcessRaisedException as exc:
        drain()
        if not failures:
            raise
        rank, failure = next(((r, f) for r, f in failures
                              if not f.collective), failures[0])
        raise mp.ProcessRaisedException(
            f"\n\n-- Process {rank} terminated with the following error:"
            f"\n{failure.traceback}", rank,
            ctx.processes[rank].pid) from exc
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    drain()
    missing = sorted(set(range(nprocs)) - set(got))
    if missing:
        raise RuntimeError(f"ranks {missing} returned no result")
    return [got[r] for r in range(nprocs)]


# -------------------------------------------------------- the level program

def _local_expand(adj, allowed, k_dev, states, count: int, *, n,
                  cap_local, block, use_mmw, use_simplicial, schedule,
                  backend):
    """Expand this rank's ``count`` rows in ``block``-row chunks; returns
    (out (cap_local, W), ocount, drops).  ``engine.shard_sweep`` with one
    lane: no cross-chunk dedup (the owner does it after routing)."""
    out, ocount, dropped = engine_lib.shard_sweep(
        adj[None], allowed[None], k_dev, states[None],
        torch.full((1,), count, dtype=torch.int32, device=states.device),
        [count], n=n, cap=cap_local, block=block, use_mmw=use_mmw,
        schedule=schedule, backend=backend, use_simplicial=use_simplicial)
    return out[0], ocount[0], dropped[0]


def _build_buckets(rows, count, ndev: int, cap_send: int):
    """Group the valid rows by owner rank -> (send (ndev, cap_send, W),
    send_counts (ndev,), dropped): ``shard.route_states``, the shared
    ownership router."""
    valid = torch.arange(rows.shape[0], device=rows.device) < count
    return shard_lib.route_states(rows, valid, ndev, cap_send)


def _all_to_all(mesh: SolverMesh, send: torch.Tensor, tr) -> torch.Tensor:
    recv = torch.empty_like(send)
    with tr.time_block("collective_s"):
        dist.all_to_all_single(recv, send.contiguous(), group=mesh.group)
    return recv


def _all_gather(mesh: SolverMesh, t: torch.Tensor, tr) -> torch.Tensor:
    """(D, *t.shape): every rank's ``t``, in rank order."""
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    with tr.time_block("collective_s"):
        dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.stack(parts)


def _transfer_matrix(counts, cap_send: int, ratio: float):
    """The mesh donation plan from every rank's post-dedup count (host
    ints): ``T[d, e]``, the rows rank d sends rank e (water-filling,
    each edge clamped to ``cap_send``; zero unless triggered), and the
    level's stats ``[triggered, rows_moved, idle, peak]``."""
    counts = np.asarray(counts, dtype=np.int64)
    targets, trig, _moved = shard_lib.donation_plan(counts, ratio)
    give = np.maximum(counts - targets, 0)
    take = np.maximum(targets - counts, 0)
    gg = np.concatenate([[0], np.cumsum(give)])
    gt = np.concatenate([[0], np.cumsum(take)])
    t_mat = np.maximum(0, np.minimum(gg[1:, None], gt[None, 1:])
                       - np.maximum(gg[:-1, None], gt[None, :-1]))
    t_mat = np.minimum(t_mat, cap_send) if trig else np.zeros_like(t_mat)
    stats = [int(trig), int(t_mat.sum()), int((counts == 0).sum()),
             int(counts.max())]
    return t_mat, stats


def _donate(mesh: SolverMesh, buf, counts, tr, *, cap_local: int,
            cap_send: int, donate_ratio: float):
    """Mesh work donation: rebalance the post-dedup rows across ranks.

    Rank d keeps its first ``keep = count - sum(T[d])`` rows and sends
    the contiguous runs ``keep + off[e] + j`` to each rank e; a receiver
    appends what it gets after its kept rows, in sender order.  Row
    order decides which children a later overflow drops, so this is the
    reference's order exactly.  Returns (buf, counts (D,) after the
    move, stats)."""
    t_mat, stats = _transfer_matrix(counts, cap_send, donate_ratio)
    if not stats[0]:
        return buf, counts, stats
    me, dev = mesh.rank, buf.device
    w = buf.shape[-1]
    row_t = t_mat[me]
    keep = int(counts[me] - row_t.sum())
    off = torch.as_tensor(np.cumsum(row_t) - row_t, device=dev)
    j = torch.arange(cap_send, device=dev)
    src = torch.clamp(keep + off[:, None] + j[None], 0, cap_local - 1)
    sval = j[None] < torch.as_tensor(row_t, device=dev)[:, None]
    send = torch.where(sval[..., None], buf[src], torch.zeros_like(buf[src]))
    recv = _all_to_all(mesh, send, tr)
    rval = (j[None] < torch.as_tensor(t_mat[:, me], device=dev)[:, None]
            ).reshape(-1)
    pos = keep + torch.cumsum(rval.to(torch.int64), 0) - 1
    dest = torch.where(rval & (pos < cap_local), pos,
                       torch.full_like(pos, cap_local))
    out = torch.zeros((cap_local + 1, w), dtype=buf.dtype, device=dev)
    out[:keep] = buf[:keep]
    out.index_put_((dest,), recv.reshape(-1, w))
    return (out[:cap_local], counts - t_mat.sum(axis=1) + t_mat.sum(axis=0),
            stats)


def _level(mesh: SolverMesh, rung, states, counts):
    """One level on this rank: local expand -> all_to_all -> owner dedup
    -> (donation).  ``counts`` is every rank's count (host).  Returns
    (states, counts after the level, the level's drops summed over the
    ranks, stats).  The host time of its collectives goes to the rung's
    tracker as ``collective_s``."""
    d, me, tr = mesh.size, mesh.rank, rung.tracker
    w = states.shape[-1]
    out, ocount, drop_local = _local_expand(
        rung.adj, rung.allowed, rung.k_dev, states, int(counts[me]),
        n=rung.n, cap_local=rung.cap_local, block=rung.block,
        use_mmw=rung.use_mmw, use_simplicial=rung.use_simplicial,
        schedule=rung.schedule, backend=rung.backend)
    send, send_counts, drop_send = _build_buckets(out, ocount, d,
                                                  rung.cap_send)
    recv = _all_to_all(mesh, send, tr)
    rcounts = _all_to_all(mesh, send_counts, tr)
    rvalid = (torch.arange(rung.cap_send, device=states.device)[None]
              < rcounts[:, None]).reshape(-1)
    buf, cnt, drop_own = dedup.dedup_compact(
        recv.reshape(d * rung.cap_send, w), rvalid, rung.cap_local)
    mine = torch.stack([cnt, drop_local + drop_send + drop_own]
                       ).to(torch.int64)
    table = _all_gather(mesh, mine, tr).cpu().numpy()   # the host read
    counts, dropped = table[:, 0], int(table[:, 1].sum())
    stats = [0, 0, 0, 0]
    if rung.donate_ratio is not None:
        buf, counts, stats = _donate(
            mesh, buf, counts, tr, cap_local=rung.cap_local,
            cap_send=rung.cap_send, donate_ratio=rung.donate_ratio)
    return buf, counts, dropped, stats


# --------------------------------------------------------- the decide loop

@dataclasses.dataclass
class DistFrontier:
    states: torch.Tensor     # (cap_local, W) int32: this rank's rows
    counts: np.ndarray       # (D,) int64: every rank's count, on the host
    level: int
    k: int


@dataclasses.dataclass
class _Rung:
    """One decide rung's operands and geometry on this rank."""
    n: int
    adj: torch.Tensor
    allowed: torch.Tensor
    k_dev: torch.Tensor
    target: int
    cap_local: int
    block: int
    cap_send: int
    use_mmw: bool
    use_simplicial: bool
    schedule: str
    backend: str
    donate_ratio: Optional[float]
    tracker: object


def _init_frontier(mesh: SolverMesh, cap_local: int, w: int):
    """The empty set, on rank 0."""
    counts = np.zeros((mesh.size,), dtype=np.int64)
    counts[0] = 1
    states = torch.zeros((cap_local, w), dtype=torch.int32,
                         device=mesh.device)
    return states, counts


def _restore(mesh: SolverMesh, ckpt: dict, cap_local: int, w: int):
    """Elastic restore: the checkpoint's live rows in rank order, dealt
    round-robin onto this mesh's ranks, at most ``cap_local`` each.
    Returns (this rank's states, every rank's count)."""
    old_counts = np.asarray(ckpt["counts"])
    old_states = np.asarray(ckpt["states"], dtype=np.uint32)
    old_cap = old_states.shape[0] // len(old_counts)
    rows = np.concatenate(
        [old_states[d * old_cap: d * old_cap + int(c)]
         for d, c in enumerate(old_counts)]
        + [np.zeros((0, w), np.uint32)], axis=0)
    counts = np.asarray([min(len(rows[d::mesh.size]), cap_local)
                         for d in range(mesh.size)], dtype=np.int64)
    mine = np.zeros((cap_local, w), dtype=np.uint32)
    mine[:counts[mesh.rank]] = rows[mesh.rank::mesh.size][:cap_local]
    return bitset.to_words(mine, mesh.device), counts


def _start(g: Graph, k: int, clique, mesh: SolverMesh, *, cap_local,
           block, use_mmw, use_simplicial, schedule, backend,
           donate_ratio, resume, tracker):
    """Validate and set up a rung; returns (rung, frontier, expanded0,
    inexact0), or None when the rung is decided without a level."""
    backend = backend or backend_lib.default_backend(mesh.device)
    backend_lib.validate(backend, mode="sort", schedule=schedule,
                         use_mmw=use_mmw, use_simplicial=use_simplicial,
                         device=mesh.device)
    n = g.n
    block = engine_lib.validate_geometry(cap_local, block)
    target = n - max(k + 1, len(clique))
    if target <= 0:
        return None
    w = bitset.n_words(n)
    dev = mesh.device
    rung = _Rung(
        n=n, adj=bitset.to_words(g.packed(), dev),
        allowed=bitset.to_words(bitset.np_allowed(n, clique), dev),
        k_dev=torch.full((1,), int(k), dtype=torch.int32, device=dev),
        target=target, cap_local=cap_local, block=block,
        cap_send=max(32, (2 * cap_local) // mesh.size), use_mmw=use_mmw,
        use_simplicial=use_simplicial, schedule=schedule, backend=backend,
        donate_ratio=donate_ratio, tracker=tracker)
    if resume is None:
        states, counts = _init_frontier(mesh, cap_local, w)
        return rung, DistFrontier(states, counts, 0, k), 0, False
    states, counts = _restore(mesh, resume, cap_local, w)
    return (rung, DistFrontier(states, counts, int(resume["level"]), k),
            int(resume.get("expanded", 0)),
            bool(resume.get("inexact", False)))


def decide_launch(g: Graph, k: int, clique, mesh: SolverMesh, *,
                  cap_local: int, block: int, use_mmw: bool = False,
                  use_simplicial: bool = False,
                  schedule: str = "doubling", backend: Optional[str] = None,
                  donate_ratio: Optional[float]
                  = shard_lib.DEFAULT_DONATE_RATIO,
                  resume: Optional[dict] = None,
                  tracker=None) -> engine_lib.DispatchHandle:
    """Run one mesh-sharded decide rung on this rank; return its handle.

    The mesh twin of ``shard.decide_sharded_async``: ``handle.result()``
    yields a one-element ``[batch.LaneResult]``, the same on every rank.
    The rung runs before this returns (one host read per level, see the
    module docstring).  ``backend`` defaults to ``cuda`` on a card and
    ``torch`` elsewhere."""
    from . import batch as batch_lib

    tr = telemetry.get(tracker)
    started = _start(g, k, clique, mesh, cap_local=cap_local, block=block,
                     use_mmw=use_mmw, use_simplicial=use_simplicial,
                     schedule=schedule, backend=backend,
                     donate_ratio=donate_ratio, resume=resume, tracker=tr)
    if started is None:
        res = [batch_lib.LaneResult(True, False, 0)]
        return engine_lib.DispatchHandle((), lambda host: res,
                                         _result=res, _done=True)
    rung, fr, expanded, inexact = started
    states, counts = fr.states, fr.counts
    dropped, stats = 0, [0, 0, 0, 0]
    for _level_i in range(fr.level, rung.target):
        if counts.sum() == 0:
            break
        expanded += int(counts.sum())
        states, counts, drop, lstats = _level(mesh, rung, states, counts)
        dropped += drop
        stats = [stats[0] + lstats[0], stats[1] + lstats[1],
                 stats[2] + lstats[2], max(stats[3], lstats[3])]
    tr.count(dispatches=1)
    feasible = bool(counts.sum() > 0)

    def finalize(host):
        shard_lib._record_stats(stats, tracker=tr)
        return [batch_lib.LaneResult(feasible, inexact or dropped > 0,
                                     expanded)]

    return engine_lib.DispatchHandle((), finalize, tracker=tr)


def decide_distributed(g: Graph, k: int, clique: list, mesh: SolverMesh,
                       *, cap_local: int, block: int, use_mmw: bool = False,
                       use_simplicial: bool = False,
                       schedule: str = "doubling",
                       backend: Optional[str] = None,
                       checkpoint_cb=None, resume: Optional[dict] = None,
                       engine: str = "fused",
                       donate_ratio: Optional[float]
                       = shard_lib.DEFAULT_DONATE_RATIO,
                       tracker=None):
    """Distributed decision on this rank: is tw(g) <= k?  Returns
    (feasible, inexact, expanded), the same on every rank.

    ``engine="fused"`` is ``decide_launch`` and ``result()``.  A
    ``checkpoint_cb`` forces the host loop, which records per-level
    telemetry and, after each level, calls ``checkpoint_cb`` on rank 0
    with the gathered frontier.  ``donate_ratio`` tunes the per-level
    work donation (None disables it)."""
    tr = telemetry.get(tracker)
    if engine == "fused" and checkpoint_cb is None:
        with tr.time_block("rung_s"):
            res = decide_launch(
                g, k, clique, mesh, cap_local=cap_local, block=block,
                use_mmw=use_mmw, use_simplicial=use_simplicial,
                schedule=schedule, backend=backend,
                donate_ratio=donate_ratio, resume=resume,
                tracker=tr).result()[0]
        return res.feasible, res.inexact, res.expanded

    started = _start(g, k, clique, mesh, cap_local=cap_local, block=block,
                     use_mmw=use_mmw, use_simplicial=use_simplicial,
                     schedule=schedule, backend=backend,
                     donate_ratio=donate_ratio, resume=resume, tracker=tr)
    if started is None:
        return True, False, 0
    rung, fr, expanded, inexact = started
    states, counts = fr.states, fr.counts
    for level in range(fr.level, rung.target):
        tr.count(host_syncs=1)
        expanded += int(counts.sum())             # states popped this level
        with tr.time_block("level_s"):
            states, counts, dropped, stats = _level(mesh, rung, states,
                                                    counts)
            tr.count(dispatches=1)
            inexact |= dropped > 0
            total = int(counts.sum())
            tr.count(host_syncs=2)
        tr.gauge_max("frontier_peak_rows", total)
        shard_lib._record_stats(stats, tracker=tr)
        if checkpoint_cb is not None:
            gathered = bitset.from_words(_all_gather(mesh, states, tr))
            if mesh.rank == 0:
                checkpoint_cb(dict(
                    level=level + 1, k=k, expanded=expanded,
                    inexact=inexact,
                    states=gathered.reshape(-1, gathered.shape[-1]),
                    counts=counts.astype(np.int32)))
        if total == 0:
            return False, inexact, expanded
    return True, inexact, expanded


def solve_distributed(g: Graph, mesh: SolverMesh, *,
                      cap_local: int = 1 << 14, block: int = 1 << 8,
                      use_mmw: bool = False, use_simplicial: bool = False,
                      schedule: str = "doubling",
                      backend: Optional[str] = None,
                      use_clique: bool = True, use_paths: bool = True,
                      use_preprocess: bool = True,
                      checkpoint_cb=None, verbose: bool = False,
                      engine: str = "fused",
                      donate_ratio: Optional[float]
                      = shard_lib.DEFAULT_DONATE_RATIO,
                      impl: Optional[str] = None,
                      tracker=None) -> SolveResult:
    """Distributed analogue of ``solver.solve`` on this rank (width only,
    no reconstruction).  Every rank plans on the host identically and
    returns the same result."""
    t0 = time.time()
    if impl is not None:
        warnings.warn("solve_distributed(impl=...) is deprecated; use "
                      "backend=...", DeprecationWarning, stacklevel=2)
        backend = impl
    if g.n == 0:
        return SolveResult(0, True, 0, 0, 0, 0.0, [], {})

    parts = [g]
    base_lb = 0
    if use_preprocess:
        pre = preprocess_lib.preprocess(g)
        parts, base_lb = [b.g for b in pre.blocks], pre.lb

    width, exact, expanded = base_lb, True, 0
    lbs = ubs = base_lb
    for part in parts:
        if part.n - 1 <= width:
            continue
        clique = bounds.greedy_max_clique(part) if use_clique else []
        lb = max(bounds.lower_bound(part), len(clique) - 1)
        ub, _ = bounds.upper_bound(part)
        lbs, ubs = max(lbs, lb), max(ubs, ub)
        if lb >= ub:
            width = max(width, ub)
            continue
        paths = bounds.disjoint_paths_matrix(part, cap=ub) \
            if use_paths else None
        found = ub
        any_inexact = False
        for k in range(lb, ub):
            gk = part.with_edges(bounds.paths_edges(part, paths, k)) \
                if use_paths else part
            feasible, inexact, exp = decide_distributed(
                gk, k, clique, mesh, cap_local=cap_local, block=block,
                use_mmw=use_mmw, use_simplicial=use_simplicial,
                schedule=schedule, backend=backend,
                checkpoint_cb=checkpoint_cb, engine=engine,
                donate_ratio=donate_ratio, tracker=tracker)
            expanded += exp
            any_inexact |= inexact
            if verbose and mesh.rank == 0:
                print(f"  [dist:{part.name}] k={k} feasible={feasible} "
                      f"exp={exp} inexact={inexact}", flush=True)
            if feasible:
                found = k
                break
        width = max(width, found)
        exact &= not any_inexact
    return SolveResult(width, exact, lbs, max(ubs, width), expanded,
                       time.time() - t0, None, None)
