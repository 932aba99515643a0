"""Iterative-deepening treewidth solver (single device).

Ports ``repro.core.solver``; the structure is the paper's (Listing 1 +
§3.1):

  for k = lb .. ub-1:                      (iterative deepening)
      G_k = G + edges{pairs with >= k+1 vertex-disjoint paths}   [rule 2]
      frontier = { {} }
      for level = 0 .. n - max(k+1, |C|) - 1:                    [rules 1,3]
          expand every S by every candidate v not in S u C,
              keeping S u {v} iff deg_S(v) <= k
              [optional: simplicial collapse, MMW prune]
          dedup (exact sort | Bloom filter)
          if frontier empty: k infeasible
      k feasible -> tw = k

Overflow of the fixed-capacity lists drops states and marks the run
inexact.  ``mode="bloom"`` is the paper's Monte-Carlo dedup (a false
positive drops a state without marking the run inexact), ``mode="sort"``
(default) the exact one.  Entry points run on ``cuda`` with the ``cuda``
backend (the hand-written kernels) unless the caller passes
``device="cpu"``, where the ``torch`` backend's plain ops run.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from . import backend as backend_lib
from . import batch as batch_lib
from . import bitset, bloom, bounds, bounds_engine, dedup
from . import engine as engine_lib
from . import frontier as frontier_lib
from . import expand
from . import preprocess as preprocess_lib
from . import shard as shard_lib
from . import telemetry
from .graph import Graph


# --------------------------------------------------------------- level loop

@dataclasses.dataclass
class LevelStats:
    expanded: int = 0
    generated: int = 0
    dropped: int = 0


def run_level(adj_dev, fr: frontier_lib.Frontier, k: int, allowed_dev,
              *, n: int, cap: int, block: int, schedule: str,
              mode: str = "sort", use_mmw: bool = False,
              m_bits: int = engine_lib.DEFAULT_M_BITS,
              k_hashes: int = bloom.DEFAULT_K, backend: str = "torch",
              use_simplicial: bool = False, tracker=None):
    """One wavefront level: expand all states in ``fr`` into a new frontier.

    Host-loop engine: an adaptive block ``max(32, min(block,
    pow2(count)))`` per level, and in sort mode a cross-chunk dedup
    whenever the level took more than one chunk.  Its two blocking reads
    (the count in, the counts out) go through ``engine.read_host``."""
    tr = telemetry.get(tracker)
    w = fr.w
    count = int(engine_lib.read_host((fr.count,), tr)[0])
    tr.count(host_syncs=1)
    block = max(32, min(block, batch_lib._pow2_at_least(max(count, 1))))
    if cap % block:
        raise ValueError(f"block ({block}) must divide cap ({cap})")
    device = adj_dev.device
    out = engine_lib.new_out(cap, w, device)
    ocount = torch.zeros((), dtype=torch.int64, device=device)
    dropped = torch.zeros((), dtype=torch.int64, device=device)
    filt = None
    if mode == "bloom":
        filt = backend_lib.get_op("bloom_make_filter", backend)(
            m_bits, device=device)
    rows = torch.arange(block, dtype=torch.int64, device=device)

    n_chunks = max(1, -(-count // block))
    for c in range(n_chunks):
        lo = c * block
        out, ocount, dropped, filt = engine_lib.expand_chunk(
            adj_dev, fr.states[lo:lo + block], (rows + lo) < count, k, out,
            ocount, dropped, filt, allowed_dev, n=n, cap=cap, block=block,
            mode=mode, use_mmw=use_mmw, m_bits=m_bits, k_hashes=k_hashes,
            schedule=schedule, backend=backend,
            use_simplicial=use_simplicial)
        tr.count(dispatches=1)
    out = out[:cap]

    if mode == "sort" and n_chunks > 1:
        valid = torch.arange(cap, device=device) < ocount
        out, ocount, drop2 = dedup.dedup_compact(out, valid, cap)
        # cross-chunk duplicates removed; drops before dedup stay counted
        dropped = dropped + drop2
        tr.count(dispatches=1)

    new_fr = frontier_lib.Frontier(out, ocount.to(torch.int32),
                                   dropped.to(torch.int32))
    generated, dropped = engine_lib.read_host((ocount, dropped), tr)
    stats = LevelStats(expanded=count, generated=int(generated),
                       dropped=int(dropped))
    tr.count(host_syncs=2)
    tr.gauge_max("frontier_peak_rows", stats.generated)
    return new_fr, stats


# ----------------------------------------------------------------- decision

@dataclasses.dataclass
class DecideResult:
    feasible: bool
    inexact: bool
    expanded: int
    levels: Optional[list]    # host snapshots when reconstructing


def decide(g: Graph, k: int, clique: list, *, cap: int, block: int,
           mode: str = "sort", use_mmw: bool = False,
           m_bits: int = engine_lib.DEFAULT_M_BITS,
           k_hashes: int = bloom.DEFAULT_K, schedule: str = "doubling",
           backend: Optional[str] = None, use_simplicial: bool = False,
           keep_levels: bool = False, engine: str = "fused", tracker=None,
           device=None) -> DecideResult:
    """Is tw(g) <= k?  ('no' may be inexact after an overflow, or Monte
    Carlo in Bloom mode.)

    ``engine="fused"`` runs ``engine.fused_decide``; ``engine="host"``
    runs ``run_level`` per level and is the only engine that keeps
    per-level snapshots (``keep_levels``, for reconstruction)."""
    device = backend_lib.resolve_device(device)
    if backend is None:
        backend = backend_lib.default_backend(device)
    backend_lib.validate(backend, mode=mode, schedule=schedule,
                         use_mmw=use_mmw, use_simplicial=use_simplicial,
                         m_bits=m_bits, device=device)
    tr = telemetry.get(tracker)
    n = g.n
    target = n - max(k + 1, len(clique))
    if target <= 0:
        return DecideResult(True, False, 0, [] if keep_levels else None)

    w = bitset.n_words(n)
    adj_dev = bitset.to_words(g.packed(), device)
    allowed_dev = bitset.to_words(bitset.np_allowed(n, clique), device)

    if keep_levels:
        engine = "host"            # per-level snapshots need the host loop
    if engine not in ("host", "fused"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "host":
        engine_lib.validate_geometry(cap, block, adaptive=True)

    if engine == "fused":
        with tr.time_block("rung_s"):
            feasible, inexact, expanded, fr = engine_lib.fused_decide(
                adj_dev, allowed_dev, k, target, n=n, cap=cap, block=block,
                mode=mode, use_mmw=use_mmw, m_bits=m_bits,
                k_hashes=k_hashes, schedule=schedule, backend=backend,
                use_simplicial=use_simplicial, tracker=tr)
        # the fused loop only surfaces the final frontier, so this is a
        # lower bound on the true per-level peak
        tr.gauge_max("frontier_peak_rows", int(fr.count))
        return DecideResult(feasible, inexact, expanded, None)

    fr = frontier_lib.empty_frontier(cap, w, device)
    expanded = 0
    inexact = False
    levels = [frontier_lib.to_host(fr)] if keep_levels else None

    with tr.time_block("rung_s"):
        for _level in range(target):
            fr, stats = run_level(adj_dev, fr, k, allowed_dev, n=n, cap=cap,
                                  block=block, schedule=schedule, mode=mode,
                                  use_mmw=use_mmw, m_bits=m_bits,
                                  k_hashes=k_hashes, backend=backend,
                                  use_simplicial=use_simplicial, tracker=tr)
            expanded += stats.expanded
            inexact |= stats.dropped > 0
            if keep_levels:
                levels.append(frontier_lib.to_host(fr))
            tr.count(host_syncs=1)
            if stats.generated == 0:
                return DecideResult(False, inexact, expanded, levels)
    return DecideResult(True, inexact, expanded, levels)


# ----------------------------------------------------------- reconstruction

def reconstruct_order(g: Graph, k: int, clique: list, levels: list) -> list:
    """Backtrack an elimination order from host level snapshots; numpy only."""
    n = g.n
    adjb = [list(map(bool, row)) for row in g.adj]
    final = levels[-1]
    if len(final) == 0:
        raise ValueError("reconstruction needs a non-empty final level")
    cur = final[0]
    order_rev = []
    for lev in range(len(levels) - 1, 0, -1):
        prev_set = {bytes(row.tobytes()) for row in levels[lev - 1]}
        cur_set = bitset.np_unpack(cur, n)
        found = False
        for v in sorted(cur_set):
            parent = cur.copy()
            parent[v >> 5] &= ~(np.uint32(1) << np.uint32(v & 31))
            if bytes(parent.tobytes()) in prev_set:
                d = expand.degree_oracle(adjb, cur_set - {v}, v)
                if d <= k:
                    order_rev.append(v)
                    cur = parent
                    found = True
                    break
        if not found:
            raise RuntimeError(
                "reconstruction failed: no parent in previous level")
    order = list(reversed(order_rev))
    remaining = sorted(set(range(n)) - set(order))
    return order + remaining


def order_width(g: Graph, order: list) -> int:
    """Replay an elimination order; max degree at elimination (oracle)."""
    adj = [set(np.nonzero(g.adj[v])[0]) for v in range(g.n)]
    width = 0
    for v in order:
        width = max(width, len(adj[v]))
        nbrs = list(adj[v])
        for i in range(len(nbrs)):
            for j in range(i + 1, len(nbrs)):
                adj[nbrs[i]].add(nbrs[j])
                adj[nbrs[j]].add(nbrs[i])
        for u in nbrs:
            adj[u].discard(v)
        adj[v].clear()
    return width


# --------------------------------------------------------------- top level

@dataclasses.dataclass
class SolveResult:
    width: int
    exact: bool
    lb: int
    ub: int
    expanded: int
    time_sec: float
    order: Optional[list] = None
    per_k: Optional[dict] = None


@dataclasses.dataclass
class BlockPlan:
    """Everything iterative deepening needs to run one block.

    ``result`` is set when no search is needed (trivial graph, ``lb >=
    ub``, or a forced ``start_k`` at/above ``ub``); its ``time_sec`` is 0
    and callers stamp their own."""
    g: Graph
    clique: list
    lb: int
    ub: int
    ub_order: list
    paths: Optional[np.ndarray]
    k0: int              # first k of the deepening ladder
    forced: bool         # k0 was pushed above the genuine lower bound
    result: Optional[SolveResult] = None

    def graph_at(self, k: int) -> Graph:
        """G_k: the paper's rule-2 graph (improved edges for width k)."""
        if self.paths is None:
            return self.g
        return self.g.with_edges(bounds.paths_edges(self.g, self.paths, k))

    def exact_at(self, k: int, any_inexact: bool) -> bool:
        """Is 'feasible at k' an exactness proof?  Only when no state was
        dropped below k and infeasibility of k-1 was established (k-1 < lb
        or decided in this run); a forced ``start_k`` above lb satisfies
        neither at ``k0``."""
        return (not any_inexact) and not (self.forced and k == self.k0)


def plan_block(g: Graph, *, use_clique: bool, use_paths: bool,
               start_k: Optional[int], heuristics: int = 0,
               seed: int = 0, tracker=None, device=None) -> BlockPlan:
    """Bounds + deepening schedule for one block.

    ``start_k`` moves the ladder's starting rung but never the reported
    lower bound; a start above it is flagged ``forced``.
    ``heuristics > 0`` runs that many anytime improver rounds
    (``core.bounds_engine``) first: a tighter lb raises ``k0`` (not
    ``forced``: the skipped rungs are refuted by a minor), a tighter ub
    shortens the ladder with its order.  ``seed`` pins every heuristic,
    so the plan is a pure function of ``(g, knobs)``.  Timed as a
    ``plan_s`` span on ``tracker`` (``None``: the process root).

    ``device`` is where the disjoint-paths matrix is computed
    (``paths_matrix``): on a CUDA device by the paths kernel, else, or
    past the kernel's n, on the host.  The matrix is the same either way."""
    tr = telemetry.get(tracker)
    with tr.time_block("plan_s"):
        return _plan_block(g, use_clique=use_clique, use_paths=use_paths,
                           start_k=start_k, heuristics=heuristics,
                           seed=seed, tracker=tr, device=device)


def paths_matrix(g: Graph, cap: int, *, tracker, device=None) -> np.ndarray:
    """``bounds.disjoint_paths_matrix(g, cap)``, timed as a ``paths_s``
    span on ``tracker``.  On a CUDA device with n within the kernel's
    reach it runs the paths kernel (``kernels/paths``) and counts
    ``paths_kernel_blocks``; otherwise the host function."""
    with tracker.time_block("paths_s"):
        if device is not None and torch.device(device).type == "cuda":
            from repro_torch.kernels.paths import ops as paths_ops
            if g.n <= paths_ops.max_vertices():
                tracker.count(paths_kernel_blocks=1)
                return paths_ops.disjoint_paths_matrix(
                    g.packed(), cap, device=device, tracker=tracker)
        return bounds.disjoint_paths_matrix(g, cap=cap)


def _plan_block(g: Graph, *, use_clique, use_paths, start_k, heuristics,
                seed, tracker, device=None) -> BlockPlan:
    if g.n <= 1:
        return BlockPlan(g, [], 0, 0, list(range(g.n)), None, 0, False,
                         SolveResult(0, True, 0, 0, 0, 0.0,
                                     list(range(g.n)), {}))
    clique = bounds.greedy_max_clique(g, seed=seed) if use_clique else []
    lb = max(bounds.lower_bound(g, seed=seed), len(clique) - 1)
    ub, ub_order = bounds.upper_bound(g, seed=seed)
    if heuristics:
        imp = bounds_engine.improve(g, lb, ub, ub_order,
                                    rounds=int(heuristics), seed=seed)
        lb, ub = imp.lb, imp.ub
        ub_order = imp.ub_order if imp.ub_order is not None else ub_order
    if lb >= ub:
        return BlockPlan(g, clique, lb, ub, ub_order, None, lb, False,
                         SolveResult(ub, True, lb, ub, 0, 0.0, ub_order, {}))
    k0, forced = lb, False
    if start_k is not None:
        k0 = max(0, int(start_k))
        forced = k0 > lb
        if k0 >= ub:
            warnings.warn(
                f"start_k={start_k} >= upper bound {ub} for {g.name}: no "
                "search performed, returning the heuristic ub as an "
                "inexact result", stacklevel=4)
            return BlockPlan(g, clique, lb, ub, ub_order, None, k0, forced,
                             SolveResult(ub, False, lb, ub, 0, 0.0,
                                         ub_order, {}))
    paths = (paths_matrix(g, ub, tracker=tracker, device=device)
             if use_paths else None)
    return BlockPlan(g, clique, lb, ub, ub_order, paths, k0, forced)


def solve_block(g: Graph, *, cap: Optional[int], block: int, mode: str,
                schedule: str, use_clique: bool, use_paths: bool,
                reconstruct: bool, start_k: Optional[int], verbose: bool,
                backend: str, use_mmw: bool = False,
                m_bits: int = engine_lib.DEFAULT_M_BITS,
                k_hashes: int = bloom.DEFAULT_K,
                use_simplicial: bool = False, engine: str = "fused",
                lanes: int = 1, shards: int = 1,
                donate_ratio: Optional[float] = None, heuristics: int = 0,
                seed: int = 0, tracker=None, device=None) -> SolveResult:
    """Iterative deepening on one (biconnected) block.

    ``cap=None`` right-sizes the frontier buffer with
    ``batch.plan_capacity`` (drop-free state bound, clamped to
    ``batch.DEFAULT_CAP``).

    ``lanes > 1`` is speculative deepening: ``k, k+1, ..., k+lanes-1`` are
    decided in one multi-lane dispatch (``batch.decide_batch``) and the
    smallest feasible rung wins.  Rungs above it are dropped uncounted,
    so widths, exactness, ``expanded`` and ``per_k`` are those of
    ``lanes=1``.  ``engine="host"`` and ``reconstruct=True`` need the
    single-lane loop and run sequential rungs.

    ``shards > 1`` decides each rung with the frontier split across S
    shards (``core.shard``), with S times the aggregate capacity.  It
    needs the fused engine (``engine="host"`` falls back to one shard)
    and forces ``lanes=1``; ``reconstruct=True`` replays the winning rung
    on the host engine, not counted in ``expanded``.  ``shards=1`` is the
    unsharded path exactly."""
    t0 = time.time()
    tr = telemetry.get(tracker)
    plan = plan_block(g, use_clique=use_clique, use_paths=use_paths,
                      start_k=start_k, heuristics=heuristics, seed=seed,
                      tracker=tr, device=device)
    if plan.result is not None:
        return dataclasses.replace(plan.result, time_sec=time.time() - t0)
    if cap is None:
        cap = batch_lib.plan_capacity(g.n, block=block)
    tr.gauge("frontier_cap", cap)

    shard_n = max(1, int(shards))
    if shard_n > 1 and engine != "fused":
        shard_n = 1       # the host loop is single-frontier only
    spec = max(1, int(lanes))
    if spec > 1 and (reconstruct or engine != "fused" or shard_n > 1):
        spec = 1          # snapshots, the host loop and shards: one lane
    decide_kw = dict(cap=cap, block=block, mode=mode, use_mmw=use_mmw,
                     m_bits=m_bits, k_hashes=k_hashes, schedule=schedule,
                     backend=backend, use_simplicial=use_simplicial,
                     device=device)
    per_k: dict = {}
    expanded_total = 0
    any_inexact = False
    k = plan.k0
    while k < plan.ub:
        ks = list(range(k, min(k + spec, plan.ub)))
        if shard_n > 1:
            with tr.time_block("rung_s"):
                results = [shard_lib.decide_sharded(
                    plan.graph_at(k), k, plan.clique, shards=shard_n,
                    donate_ratio=donate_ratio, tracker=tr, **decide_kw)]
        elif spec > 1:
            with tr.time_block("rung_s"):
                results = batch_lib.decide_batch(
                    g, ks, plan.clique,
                    graphs=[plan.graph_at(kk) for kk in ks], tracker=tr,
                    **decide_kw)
        else:
            results = [decide(plan.graph_at(k), k, plan.clique,
                              keep_levels=reconstruct, engine=engine,
                              tracker=tr, **decide_kw)]
        for kk, res in zip(ks, results):
            expanded_total += res.expanded
            counts = dict(rungs_decided=1, expanded=res.expanded)
            if res.inexact:
                counts["rung_overflows"] = 1
            tr.count(**counts)
            per_k[kk] = {"feasible": res.feasible, "inexact": res.inexact,
                         "expanded": res.expanded}
            if verbose:
                print(f"  [{g.name}] k={kk} feasible={res.feasible} "
                      f"expanded={res.expanded} inexact={res.inexact}",
                      flush=True)
            if res.feasible:
                order = None
                if reconstruct:
                    levels = getattr(res, "levels", None)
                    if levels is None:
                        # a sharded rung: replay it on the host engine for
                        # level snapshots, not counted in ``expanded``
                        levels = decide(plan.graph_at(kk), kk, plan.clique,
                                        keep_levels=True, engine="host",
                                        tracker=tr, **decide_kw).levels
                    order = reconstruct_order(plan.graph_at(kk), kk,
                                              plan.clique, levels)
                return SolveResult(kk, plan.exact_at(kk, any_inexact),
                                   plan.lb, plan.ub, expanded_total,
                                   time.time() - t0, order, per_k)
            if res.inexact:
                # a state leading to a width-k order may have been
                # dropped: anything concluded beyond this k is a
                # candidate value only
                any_inexact = True
        k = ks[-1] + 1
    return SolveResult(plan.ub, not any_inexact, plan.lb, plan.ub,
                       expanded_total, time.time() - t0, plan.ub_order,
                       per_k)


@dataclasses.dataclass
class SuiteFold:
    """Accumulator folding per-block results into one instance result."""
    width: int
    exact: bool = True
    expanded: int = 0
    lbs: int = 0
    ubs: int = 0
    per_k: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def start(cls, lb: int) -> "SuiteFold":
        return cls(width=lb, lbs=lb, ubs=lb)

    def skip(self, g: Graph) -> bool:
        """A block can't beat the width found so far (and then any
        elimination order of it fits the width budget)."""
        return g.n - 1 <= self.width

    def add(self, name: str, res: SolveResult) -> None:
        self.width = max(self.width, res.width)
        self.exact &= res.exact
        self.expanded += res.expanded
        self.lbs = max(self.lbs, res.lb)
        self.ubs = max(self.ubs, res.ub)
        self.per_k[name] = res.per_k

    def result(self, elapsed: float, order=None) -> SolveResult:
        return SolveResult(self.width, self.exact, self.lbs,
                           max(self.ubs, self.width), self.expanded,
                           elapsed, order, self.per_k)


def solve(g: Graph, *, cap: Optional[int] = None, block: int = 1 << 11,
          mode: str = "sort", use_mmw: bool = False,
          m_bits: int = engine_lib.DEFAULT_M_BITS,
          k_hashes: int = bloom.DEFAULT_K,
          schedule: Optional[str] = None, use_clique: bool = True,
          use_paths: bool = True, use_preprocess: bool = True,
          reconstruct: bool = False, start_k: Optional[int] = None,
          verbose: bool = False, backend: Optional[str] = None,
          use_simplicial: bool = False, engine: str = "fused",
          lanes: int = 1, shards: int = 1,
          donate_ratio: Optional[float] = None, heuristics: int = 0,
          seed: int = 0, tracker=None, device=None) -> SolveResult:
    """Compute the treewidth of ``g``.

    Runs on ``device`` (default ``cuda``; ``"cpu"`` for the plain ops) with
    ``backend`` (default ``cuda`` on a card, ``torch`` elsewhere).
    ``cap=None`` auto-sizes the frontier per preprocessed block;
    ``schedule=None`` is the static ``doubling`` closure.  ``engine``
    picks the fused level loop or the per-level host loop; the host loop
    is forced where ``reconstruct=True`` needs level snapshots, and the
    block-local orders are stitched back through the preprocess vertex
    maps.  ``mode="bloom"`` dedups with an ``m_bits``-bit Bloom filter
    probed ``k_hashes`` times per state (the paper's configuration, with
    ``use_mmw=True``); ``use_mmw`` and ``use_simplicial`` turn on the MMW
    prune and the simplicial collapse.  ``lanes > 1`` decides that many
    consecutive rungs per dispatch (speculative deepening, same results);
    across instances, see ``batch.solve_many``.  ``shards > 1`` splits
    each rung's frontier across S shards (``core.shard``, owner-hash
    routing and work donation tuned by ``donate_ratio``; forces
    ``lanes=1``).  ``heuristics > 0`` runs that many anytime bounds
    rounds (``core.bounds_engine``) before each block's ladder, with
    every draw pinned by ``seed``."""
    t0 = time.time()
    device = backend_lib.resolve_device(device)
    if backend is None:
        backend = backend_lib.default_backend(device)
    if schedule is None:
        schedule = "doubling"
    backend_lib.validate(backend, mode=mode, schedule=schedule,
                         use_mmw=use_mmw, use_simplicial=use_simplicial,
                         m_bits=m_bits, lanes=int(lanes),
                         shards=int(shards), device=device)
    if g.n == 0:
        return SolveResult(0, True, 0, 0, 0, 0.0, [], {})
    solve_kw = dict(cap=cap, block=block, mode=mode, use_mmw=use_mmw,
                    m_bits=m_bits, k_hashes=k_hashes, schedule=schedule,
                    use_clique=use_clique, use_paths=use_paths,
                    start_k=start_k, verbose=verbose, backend=backend,
                    use_simplicial=use_simplicial, engine=engine,
                    lanes=lanes, shards=shards, donate_ratio=donate_ratio,
                    heuristics=heuristics, seed=seed, tracker=tracker,
                    device=device)
    if not use_preprocess:
        return solve_block(g, reconstruct=reconstruct, **solve_kw)

    pre = preprocess_lib.preprocess(g, tracker=tracker)
    fold = SuiteFold.start(pre.lb)
    block_orders: list = [None] * len(pre.blocks)
    for i, part in enumerate(pre.blocks):
        if fold.skip(part.g):
            continue
        res = solve_block(part.g, reconstruct=reconstruct, **solve_kw)
        fold.add(part.g.name, res)
        block_orders[i] = res.order
    order = None
    if reconstruct:
        order = stitch_and_verify(g, pre, block_orders, fold.width)
    return fold.result(time.time() - t0, order)


def stitch_and_verify(g: Graph, pre, block_orders: list,
                      width: int) -> Optional[list]:
    """Stitch per-block elimination orders into a global certificate and
    replay-check it.  Returns ``None`` (with a warning) if the stitched
    order replays above the computed width."""
    order = preprocess_lib.stitch_block_orders(pre, block_orders)
    replay = order_width(g, order)
    if replay > width:
        warnings.warn(
            f"stitched elimination order replays at width {replay} > "
            f"computed width {width}; dropping the order (please "
            "report — this indicates a preprocess/stitch bug)",
            stacklevel=2)
        return None
    return order
