"""Multi-lane engine: one dispatch decides several subproblems
(``repro.core.batch``).

  * ``decide_lanes_async`` packs lanes into a common ``(n_max, W)`` space
    and runs ``engine.decide_loop`` over them: every lane carries its
    own ``(adj, allowed, k, target)`` and frontier, stops on its own, and
    gets the result it would get alone.  The reference vmaps
    ``engine.decide_loop``; here the lane axis is written out, down to the
    kernels, which launch once for every lane (``wavefront_expand`` and
    ``bloom_query_insert`` with a leading lane axis).
  * ``decide_lanes`` is launch plus immediate ``result()``.
  * ``decide_batch(g, ks)`` is speculative deepening: decide ``k, k+1, ..``
    for one graph at once (``solver.solve_block(lanes=...)``; the smallest
    feasible rung wins).
  * ``solve_many(graphs)`` pads a whole suite's blocks to one ``(n_max,
    W)`` and schedules their rungs in lanes, with ``solver.solve``'s
    per-instance results.
  * ``InstanceState`` is the per-request unit both drivers advance rung
    by rung.
  * ``plan_capacity`` right-sizes per-lane frontier buffers.

Padding: a lane of true size ``n_g`` is embedded at the bottom of the
common ``n_max`` index space; padding vertices are isolated in ``adj`` and
cleared from ``allowed``, so they are never candidates and never change a
closure, and padded state words are zero, so the sort order is the
unpadded one.  Two caveats, as in the reference, both absent when lanes
share one true ``n`` (speculative deepening): (1) MMW sees the padding
vertices as isolated degree-0 rows, which can only weaken the bound, so
verdicts are unchanged but ``expanded`` under ``use_mmw=True`` may exceed
the sequential count; (2) Bloom hashes cover all ``W`` words, so a lane
padded to a larger word count draws another (still Monte-Carlo correct)
false-positive set than its sequential run.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import backend as backend_lib
from . import bitset, bloom
from . import engine as engine_lib
from . import frontier as frontier_lib
from . import preprocess as preprocess_lib
from . import telemetry
from .graph import Graph

# default lane width of one dispatch
DEFAULT_MAX_LANES = 8

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
    ``lanes * cap * W * 4`` bytes (``"auto"`` reads
    ``backend.device_memory_budget()``, ``None`` on the CPU); a binding
    budget may reintroduce drops.
    """
    if n <= 1:
        need = 1
    else:
        need = n * math.comb(n, n // 2) + 1
    cap_hi = _pow2_floor(cap_max)
    cap = min(_pow2_at_least(need), cap_hi)
    cap = max(cap, 32, _pow2_at_least(min(block, cap_hi)))
    if budget_bytes == "auto":
        budget_bytes = backend_lib.device_memory_budget()
    if budget_bytes is not None:
        row_bytes = 4 * max(1, w if w is not None else bitset.n_words(n))
        afford = int(budget_bytes) // (max(1, lanes) * row_bytes)
        cap = max(32, min(cap, _pow2_floor(afford)))
    return cap


@dataclasses.dataclass(frozen=True)
class Lane:
    """One subproblem: decide tw(g) <= k, skipping ``clique`` (never
    eliminated: some optimal order ends with the max clique)."""
    g: Graph
    k: int
    clique: tuple = ()


@dataclasses.dataclass
class LaneResult:
    """Per-lane verdict; ``solver.DecideResult`` without level snapshots."""
    feasible: bool
    inexact: bool
    expanded: int


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


def _pack_lanes(lanes: Sequence[Lane], n_max: int, w: int):
    """Embed every lane in the common (n_max, W) space on the host.

    Padding vertices stay isolated (zero adjacency rows) and are cleared
    from ``allowed``; ``target`` counts the lane's *true* levels, so it
    runs exactly as long as its unpadded decide.  A lane whose target is
    <= 0 is trivially feasible and stops before its first level, as
    ``solver.decide`` returns early."""
    b = len(lanes)
    adj = np.zeros((b, n_max, w), dtype=np.uint32)
    allowed = np.zeros((b, w), dtype=np.uint32)
    ks = np.zeros((b,), dtype=np.int32)
    targets = np.zeros((b,), dtype=np.int32)
    for i, lane in enumerate(lanes):
        p = lane.g.packed()
        adj[i, :lane.g.n, :p.shape[1]] = p
        allowed[i] = bitset.np_allowed(lane.g.n, lane.clique, w)
        ks[i] = lane.k
        targets[i] = max(0, lane.g.n - max(lane.k + 1, len(lane.clique)))
    return adj, allowed, ks, targets


_TRIVIAL = Graph(1, np.zeros((1, 1), dtype=bool), "pad")


def _empty_dispatch() -> engine_lib.DispatchHandle:
    """A no-op handle: zero lanes, nothing dispatched, nothing to read."""
    return engine_lib.DispatchHandle((), lambda host: [],
                                     _result=[], _done=True)


def decide_lanes_async(lanes: Sequence[Lane], *, cap: Optional[int] = None,
                       block: int, mode: str, use_mmw: bool, m_bits: int,
                       k_hashes: int, schedule: str = "doubling",
                       backend: Optional[str] = None,
                       use_simplicial: bool = False,
                       n_pad: Optional[int] = None,
                       lane_pad: Optional[int] = None,
                       cap_max: int = DEFAULT_CAP, budget_bytes=None,
                       tracker=None, device=None
                       ) -> engine_lib.DispatchHandle:
    """Run one multi-lane dispatch; return its handle.

    ``handle.result()`` makes the one copy of the (L,) verdicts to the
    host and yields the ``List[LaneResult]`` ``decide_lanes`` returns.
    The level loop reads each level's counts on the host, so this returns
    once the last level is enqueued.  Runs on ``device`` (default
    ``cuda``) with ``backend`` (default ``cuda`` on a card, ``torch``
    elsewhere).

        h = batch.decide_lanes_async([batch.Lane(g, 3)], block=32,
                                     mode="sort", use_mmw=False,
                                     m_bits=1 << 12, k_hashes=4,
                                     device="cpu")
        [verdict] = h.result()
    """
    if not lanes:
        return _empty_dispatch()
    device = backend_lib.resolve_device(device)
    if backend is None:
        backend = backend_lib.default_backend(device)
    backend_lib.validate(backend, mode=mode, schedule=schedule,
                         use_mmw=use_mmw, use_simplicial=use_simplicial,
                         m_bits=m_bits, lanes=len(lanes), device=device)
    if budget_bytes == "auto":
        budget_bytes = backend_lib.device_memory_budget(device=device)
    live = len(lanes)
    n_max = max(lane.g.n for lane in lanes)
    if n_pad is not None:
        if n_pad < n_max:
            raise ValueError(f"n_pad ({n_pad}) < largest lane n ({n_max})")
        n_max = n_pad
    n_max = max(1, n_max)
    if lane_pad is not None and lane_pad > live:
        lanes = list(lanes) + [Lane(_TRIVIAL, 0)] * (lane_pad - live)
    w = bitset.n_words(n_max)
    if cap is None:
        cap = max(plan_capacity(lane.g.n, w, lanes=len(lanes), block=block,
                                cap_max=cap_max, budget_bytes=budget_bytes)
                  for lane in lanes)
    block = engine_lib.validate_geometry(cap, block)

    adj, allowed, ks, targets = _pack_lanes(lanes, n_max, w)
    fr = frontier_lib.lane_frontiers(len(lanes), cap, w, device)
    out_fr, _levels, expanded, dropped = engine_lib.decide_loop(
        bitset.to_words(adj, device), bitset.to_words(allowed, device),
        torch.from_numpy(ks).to(device), targets.tolist(), fr, n=n_max,
        cap=cap, block=block, mode=mode, use_mmw=use_mmw, m_bits=m_bits,
        k_hashes=k_hashes, schedule=schedule, backend=backend,
        use_simplicial=use_simplicial)
    tr = telemetry.get(tracker)
    tr.count(dispatches=1)
    event = None
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record()

    def finalize(host):
        counts_h, exp_h, drop_h = host
        out = [LaneResult(bool(counts_h[i] > 0), bool(drop_h[i] > 0),
                          int(exp_h[i])) for i in range(live)]
        # per-lane work: lanes decided, states they expanded, lanes that
        # overflowed (inexact)
        tr.count(lanes_decided=live,
                 lane_expanded=sum(r.expanded for r in out),
                 lane_overflows=sum(1 for r in out if r.inexact))
        return out

    return engine_lib.DispatchHandle((out_fr.count, expanded, dropped),
                                     finalize, tracker=tr, event=event)


def decide_lanes(lanes: Sequence[Lane], *, cap: Optional[int] = None,
                 block: int, mode: str, use_mmw: bool, m_bits: int,
                 k_hashes: int, schedule: str = "doubling",
                 backend: Optional[str] = None,
                 use_simplicial: bool = False,
                 n_pad: Optional[int] = None,
                 lane_pad: Optional[int] = None,
                 cap_max: int = DEFAULT_CAP, budget_bytes=None,
                 tracker=None, device=None) -> List[LaneResult]:
    """Decide every lane in one dispatch; one copy of all verdicts.

    ``n_pad`` pins the padded vertex count and ``lane_pad`` rounds the
    lane count up with trivial lanes (the reference pads to reuse its
    compiled programs; here they only shape the dispatch).  ``cap=None``
    sizes the shared per-lane buffer with ``plan_capacity``: the largest
    lane's drop-free bound, clamped to ``cap_max`` (and to
    ``budget_bytes`` over the whole pool when given)."""
    return decide_lanes_async(
        lanes, cap=cap, block=block, mode=mode, use_mmw=use_mmw,
        m_bits=m_bits, k_hashes=k_hashes, schedule=schedule,
        backend=backend, use_simplicial=use_simplicial, n_pad=n_pad,
        lane_pad=lane_pad, cap_max=cap_max, budget_bytes=budget_bytes,
        tracker=tracker, device=device).result()


def decide_batch(g: Graph, ks: Sequence[int], clique: Sequence[int] = (),
                 *, graphs: Optional[Sequence[Graph]] = None,
                 cap: Optional[int] = None, block: int, mode: str,
                 use_mmw: bool, m_bits: int, k_hashes: int,
                 schedule: str = "doubling", backend: Optional[str] = None,
                 use_simplicial: bool = False, tracker=None,
                 device=None) -> List[LaneResult]:
    """Speculative deepening: decide tw(g) <= k for several k in one
    dispatch.

    ``graphs`` optionally overrides the graph per rung (the deepening
    driver passes the paths-rule graph ``G_k`` of each k).  All lanes
    share the true ``n``, so the results are the sequential ``decide``
    loop's for every mode and pruning flag."""
    if graphs is not None and len(graphs) != len(ks):
        raise ValueError("graphs must align with ks")
    lanes = [Lane(graphs[i] if graphs is not None else g, int(k),
                  tuple(clique)) for i, k in enumerate(ks)]
    return decide_lanes(lanes, cap=cap, block=block, mode=mode,
                        use_mmw=use_mmw, m_bits=m_bits, k_hashes=k_hashes,
                        schedule=schedule, backend=backend,
                        use_simplicial=use_simplicial, tracker=tracker,
                        device=device)


# ----------------------------------------------------------- suite driver

@dataclasses.dataclass
class _Run:
    """Iterative deepening in progress on one block (the ladder state of
    ``solver.solve_block``)."""
    plan: object                  # solver.BlockPlan
    k: int
    idx: int = 0                  # index into the preprocess block list
    expanded: int = 0
    any_inexact: bool = False
    per_k: dict = dataclasses.field(default_factory=dict)


class InstanceState:
    """One input graph's scheduler state: the ``solve``-shaped fold over
    its preprocessed blocks (``solver.SuiteFold``, the accumulator
    ``solve`` uses), advanced block by block as lane verdicts come back.

    ``solve_many`` walks a suite of these; a serving scheduler keeps one
    per request.  ``result`` is set (a ``solver.SolveResult``) once the
    instance is decided; until then ``run`` names the block rung that
    occupies a lane.

    ``reconstruct=True`` certifies the result with an elimination order:
    a block's winning rung is replayed once on the host engine
    (``keep_levels=True``) for its level snapshots, not counted in
    ``expanded`` (the sequential path also expands that rung once), and
    the block orders are stitched as ``solve(reconstruct=True)`` does.
    ``recon_kw`` carries the decide arguments of that replay (``cap=None``
    re-plans per block with ``plan_capacity``)."""

    def __init__(self, g: Graph, solver_lib, *, use_preprocess: bool,
                 plan_kw: dict, reconstruct: bool = False,
                 recon_kw: Optional[dict] = None, tracker=None):
        self.g = g
        self.solver = solver_lib
        self.plan_kw = plan_kw
        # per-request telemetry scope; NULL unless the caller opts in
        self.tracker = telemetry.NULL if tracker is None else tracker
        self.reconstruct = reconstruct
        self.recon_kw = dict(recon_kw or {})
        self.t0 = time.time()
        self.result: Optional[object] = None     # solver.SolveResult
        self.run: Optional[_Run] = None
        self.pre = None                          # preprocess.Preprocessed
        self.use_pre = use_preprocess
        self.bi = 0
        if g.n == 0:
            self.parts: list = []
            self.fold = None
            self.block_orders: list = []
            self.result = solver_lib.SolveResult(0, True, 0, 0, 0, 0.0,
                                                 [], {})
            return
        if use_preprocess:
            self.pre = preprocess_lib.preprocess(g)
            self.parts = [b.g for b in self.pre.blocks]
            self.fold = solver_lib.SuiteFold.start(self.pre.lb)
        else:
            self.parts = [g]
            self.fold = None      # single block: adopt its result wholesale
        self.block_orders = [None] * len(self.parts)
        self._advance()

    def max_n(self) -> int:
        return max([p.n for p in self.parts], default=1)

    # ------------------------------------------------- anytime accounting

    def bounds(self) -> tuple:
        """Running instance-level ``(lb, ub)``.

        lb: the preprocess bound, the finished blocks' fold, the current
        block's ``plan.lb`` and its refuted rungs (only when k0 was not
        forced and nothing was dropped).  ub: the max over parts of the
        finished blocks' widths, the current block's ``plan.ub`` and
        n-1 for blocks not yet planned."""
        lb = self.pre.lb if self.pre is not None else 0
        ub_parts = [0]
        if self.fold is not None:
            lb = max(lb, self.fold.lbs)
            if self.fold.exact:
                lb = max(lb, self.fold.width)
            ub_parts.append(self.fold.width)
        run = self.run
        if run is not None:
            lb = max(lb, run.plan.lb)
            if not run.plan.forced and not run.any_inexact:
                lb = max(lb, run.k)
            ub_parts.append(run.plan.ub)
        ub_parts.extend(p.n - 1 for p in self.parts[self.bi:])
        return lb, max(ub_parts)

    def partial(self) -> tuple:
        """``(expanded, per_k)`` so far: finished blocks plus the current
        block's ladder."""
        run = self.run
        if self.fold is None:          # use_preprocess=False: solve_block
            if run is None:            # shape, per_k keyed directly by k
                return 0, {}
            return run.expanded, dict(run.per_k)
        expanded = self.fold.expanded
        per_k = dict(self.fold.per_k)
        if run is not None:
            expanded += run.expanded
            per_k[run.plan.g.name] = dict(run.per_k)
        return expanded, per_k

    def anytime_result(self, lb: Optional[int] = None,
                       ub: Optional[int] = None):
        """Resolve the instance now with its best-so-far bounds:
        ``width=ub``, ``exact=False`` and the partial ``expanded`` and
        ``per_k``.  ``lb``/``ub`` default to ``bounds()``."""
        b_lb, b_ub = self.bounds()
        lb = b_lb if lb is None else lb
        ub = b_ub if ub is None else ub
        expanded, per_k = self.partial()
        return self.solver.SolveResult(ub, False, lb, ub, expanded,
                                       time.time() - self.t0, None, per_k)

    def _fold(self, bres, name: str, idx: int):
        if self.reconstruct:
            self.block_orders[idx] = bres.order
        if not self.use_pre:
            self.result = dataclasses.replace(
                bres, time_sec=time.time() - self.t0)
            return
        self.fold.add(name, bres)

    def _advance(self):
        """Start the next runnable block, or finish the instance."""
        while self.run is None and self.result is None:
            if self.bi >= len(self.parts):
                if self.use_pre:
                    order = None
                    if self.reconstruct:
                        order = self.solver.stitch_and_verify(
                            self.g, self.pre, self.block_orders,
                            self.fold.width)
                    self.result = self.fold.result(
                        time.time() - self.t0, order)
                return
            part = self.parts[self.bi]
            idx = self.bi
            self.bi += 1
            if self.use_pre and self.fold.skip(part):
                continue
            plan = self.solver.plan_block(part, **self.plan_kw)
            if plan.result is not None:
                self._fold(plan.result, part.name, idx)
                continue
            self.run = _Run(plan, k=plan.k0, idx=idx)

    def _certify(self, plan, k: int) -> Optional[list]:
        """Replay the winning rung on the host engine for level snapshots
        and backtrack an elimination order (not counted)."""
        kw = dict(self.recon_kw)
        if kw.get("cap") is None:
            kw["cap"] = plan_capacity(plan.g.n, block=kw.get("block", 32),
                                      cap_max=kw.pop("cap_max", DEFAULT_CAP))
        else:
            kw.pop("cap_max", None)
        res = self.solver.decide(plan.graph_at(k), k, plan.clique,
                                 keep_levels=True, engine="host", **kw)
        return self.solver.reconstruct_order(plan.graph_at(k), k,
                                             plan.clique, res.levels)

    def finish_block(self, k_found: Optional[int]):
        run = self.run
        plan = run.plan
        if k_found is not None:
            order = (self._certify(plan, k_found)
                     if self.reconstruct else None)
            bres = self.solver.SolveResult(
                k_found, plan.exact_at(k_found, run.any_inexact), plan.lb,
                plan.ub, run.expanded, 0.0, order, run.per_k)
        else:
            bres = self.solver.SolveResult(
                plan.ub, not run.any_inexact, plan.lb, plan.ub,
                run.expanded, 0.0, plan.ub_order, run.per_k)
        self.run = None
        self._fold(bres, plan.g.name, run.idx)
        self._advance()

    def feed(self, k: int, res: LaneResult) -> bool:
        """Take one rung verdict with the sequential ladder's accounting.

        Returns ``False`` once the block finished on this verdict (a
        speculative caller drops its remaining rungs uncounted: the
        sequential ladder never ran them), ``True`` while the ladder goes
        on."""
        run = self.run
        run.expanded += res.expanded
        run.per_k[k] = {"feasible": res.feasible, "inexact": res.inexact,
                        "expanded": res.expanded}
        counts = dict(rungs_decided=1, expanded=res.expanded)
        if res.inexact:
            counts["rung_overflows"] = 1
        self.tracker.count(**counts)
        if res.feasible:
            self.finish_block(k)
            return False
        if res.inexact:
            run.any_inexact = True
        run.k = k + 1
        if run.k >= run.plan.ub:
            self.finish_block(None)
            return False
        return True

    def improve_bounds(self, lb: Optional[int] = None,
                       ub: Optional[int] = None,
                       ub_order: Optional[list] = None) -> dict:
        """Clamp heuristic bounds into the current block's ladder (tighten
        only).

        A tighter ub with its order certificate shortens the ladder; a
        tighter lb skips rungs, and the skipped rungs are never
        dispatched.  A ladder that closes (``run.k >= plan.ub``) resolves
        through ``finish_block(None)``.  Returns ``{lb_improved,
        ub_improved, rungs_skipped, finished}`` (``finished``: the whole
        instance resolved); hints without an order, stale hints and
        loosenings are ignored."""
        out = dict(lb_improved=False, ub_improved=False, rungs_skipped=0,
                   finished=False)
        run = self.run
        if run is None or self.result is not None:
            return out
        plan = run.plan
        if ub is not None and ub_order is not None and int(ub) < plan.ub:
            out["rungs_skipped"] += plan.ub - max(int(ub), run.k)
            plan.ub = int(ub)
            plan.ub_order = list(ub_order)
            out["ub_improved"] = True
        if lb is not None and int(lb) > plan.lb:
            plan.lb = min(int(lb), plan.ub)
            out["lb_improved"] = True
            if plan.lb > run.k:
                out["rungs_skipped"] += plan.lb - run.k
                run.k = plan.lb
        if run.k >= plan.ub:
            self.finish_block(None)
        out["finished"] = self.result is not None
        return out


def solve_many(graphs: Sequence[Graph], *, cap: Optional[int] = None,
               block: int = 1 << 11, mode: str = "sort",
               use_mmw: bool = False, m_bits: int = 1 << 24,
               k_hashes: int = bloom.DEFAULT_K,
               schedule: Optional[str] = None, use_clique: bool = True,
               use_paths: bool = True, use_preprocess: bool = True,
               reconstruct: bool = False,
               start_k: Optional[int] = None, verbose: bool = False,
               backend: Optional[str] = None, use_simplicial: bool = False,
               lanes: int = DEFAULT_MAX_LANES, speculate: int = 1,
               budget_bytes=None, device=None) -> List[object]:
    """Solve a whole suite with lanes across instances.

    Returns one ``solver.SolveResult`` per input, in input order, with the
    widths, exactness, bounds, ``per_k`` and ``expanded`` of the
    sequential ``[solve(g) for g in graphs]`` loop, subject to the two
    padding caveats in the module docstring (MMW with a padded n, Bloom
    with a padded W).  Every round packs all instances' current rungs
    into dispatches of up to ``lanes`` lanes; ``speculate > 1`` lets each
    instance take that many consecutive-k lanes per round.
    ``schedule=None`` is ``doubling``, the port's only closure schedule.

    ``cap=None`` sizes one shared per-lane buffer for the whole suite with
    ``plan_capacity`` (the largest block's drop-free bound, clamped to
    ``DEFAULT_CAP`` / ``budget_bytes``).  ``reconstruct=True`` certifies
    every result with a stitched elimination order, as
    ``solver.solve(reconstruct=True)``.

        from repro_torch.core import batch, graph
        res = batch.solve_many([graph.myciel(4), graph.petersen()],
                               lanes=8, device="cpu")
        [r.width for r in res]            # -> [10, 4]
    """
    from . import solver as solver_lib   # lazy: solver imports this module

    if schedule is None:
        schedule = "doubling"
    device = backend_lib.resolve_device(device)
    if backend is None:
        backend = backend_lib.default_backend(device)
    lanes = int(lanes)
    speculate = max(1, int(speculate))
    backend_lib.validate(backend, mode=mode, schedule=schedule,
                         use_mmw=use_mmw, use_simplicial=use_simplicial,
                         m_bits=m_bits, lanes=lanes, device=device)
    if budget_bytes == "auto":
        budget_bytes = backend_lib.device_memory_budget(device=device)
    decide_kw = dict(cap=cap, block=block, mode=mode, use_mmw=use_mmw,
                     m_bits=m_bits, k_hashes=k_hashes, schedule=schedule,
                     backend=backend, use_simplicial=use_simplicial,
                     budget_bytes=budget_bytes, device=device)
    plan_kw = dict(use_clique=use_clique, use_paths=use_paths,
                   start_k=start_k)
    recon_kw = dict(cap=cap, block=block, mode=mode, use_mmw=use_mmw,
                    m_bits=m_bits, k_hashes=k_hashes, schedule=schedule,
                    backend=backend, use_simplicial=use_simplicial,
                    device=device)

    insts = [InstanceState(g, solver_lib, use_preprocess=use_preprocess,
                           plan_kw=plan_kw, reconstruct=reconstruct,
                           recon_kw=recon_kw) for g in graphs]
    n_pad = max([i.max_n() for i in insts], default=1)
    if cap is None:
        # one plan for the whole suite (its largest block)
        w = bitset.n_words(n_pad)
        decide_kw["cap"] = max(plan_capacity(
            p.n, w, lanes=lanes, block=block, budget_bytes=budget_bytes)
            for i in insts for p in i.parts) if any(i.parts for i in insts) \
            else 32

    rnd = 0
    while True:
        live = [inst for inst in insts if inst.run is not None]
        if not live:
            break
        sched = []
        lane_list: list = []
        for inst in live:
            run = inst.run
            ks = list(range(run.k, min(run.k + speculate, run.plan.ub)))
            sched.append((inst, ks))
            lane_list.extend(
                Lane(run.plan.graph_at(kk), kk, tuple(run.plan.clique))
                for kk in ks)
        if verbose:
            print(f"[solve_many] round {rnd}: {len(lane_list)} lanes over "
                  f"{len(live)} instances", flush=True)
        results: list = []
        for lo in range(0, len(lane_list), lanes):
            group = lane_list[lo:lo + lanes]
            results.extend(decide_lanes(
                group, n_pad=n_pad,
                lane_pad=min(lanes, _pow2_at_least(len(group))),
                **decide_kw))
        pos = 0
        for inst, ks in sched:
            name = inst.run.plan.g.name
            rungs = results[pos:pos + len(ks)]
            pos += len(ks)
            for kk, res in zip(ks, rungs):
                if verbose:
                    print(f"  [{name}] k={kk} "
                          f"feasible={res.feasible} "
                          f"expanded={res.expanded} "
                          f"inexact={res.inexact}", flush=True)
                if not inst.feed(kk, res):
                    # block finished on this rung: the rungs above it were
                    # never run sequentially, so they are dropped uncounted
                    break
        rnd += 1
    return [inst.result for inst in insts]
