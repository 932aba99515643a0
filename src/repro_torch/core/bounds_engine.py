"""Anytime heuristic bounds engine (``repro.core.bounds_engine``).

The exact ladder only moves a request's bounds when a Held-Karp rung
decides.  This module supplies cheap improvers around it (Tamaki's
"Heuristic computation of exact treewidth"):

  * upper bounds   -- seeded randomized min-degree / min-fill elimination
    sweeps.  The randomized min-degree sweep also runs batched over a
    whole pool of graphs on the device (``ub_orders_async``).
  * lower bounds   -- MMW over randomized edge contractions
    (``contraction_lb``): every contracted graph is a minor, so its min
    degree bounds tw from below.

Improvers only tighten (ub with a replayable elimination order, lb by a
minor argument), so callers may clamp the exact ladder with them without
changing a verdict.  ``HeuristicState`` is the bounds-only request state
with the surface of ``batch.InstanceState`` that a scheduler touches.

Everything is deterministic per (graph, seed): every draw comes from
numpy's ``RandomState`` in the reference's order, never from torch's RNG,
so bounds, ranks and orders equal the reference's seed for seed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from . import bounds, telemetry
from .graph import Graph

_MIX = 1000003  # seed mixer: keeps per-round streams disjoint

# sweeps run by ``ub_orders_async`` on a device (one per dispatch)
LAUNCHES = 0


def _round_seed(seed: int, rnd: int) -> int:
    return (int(seed) * _MIX + int(rnd)) % (2 ** 31 - 1)


# ---------------------------------------------------------------------------
# lower-bound improver: MMW on randomized edge contractions (host, numpy)
# ---------------------------------------------------------------------------

def contraction_lb(g: Graph, seed: int = 0) -> int:
    """One seeded MMW contraction sweep; returns a valid lower bound.

    Repeatedly record the current minimum degree, then contract a
    minimum-degree vertex into a uniformly random neighbour."""
    n = g.n
    if n <= 1:
        return 0
    rng = np.random.RandomState(seed)
    a = g.adj.copy()
    alive = np.ones(n, dtype=bool)
    lb = 0
    while int(alive.sum()) > 1:
        cand = np.nonzero(alive)[0]
        deg = a[cand].sum(axis=1)
        lb = max(lb, int(deg.min()))
        v = int(cand[int(np.argmin(deg))])
        nbrs = np.nonzero(a[v])[0]
        if len(nbrs) == 0:
            alive[v] = False
            continue
        u = int(nbrs[rng.randint(len(nbrs))])
        merged = a[u] | a[v]
        merged[u] = merged[v] = False
        a[u] = merged
        a[:, u] = merged
        a[v] = False
        a[:, v] = False
        alive[v] = False
    return lb


# ---------------------------------------------------------------------------
# host improvement loop (solver path): rounds of ub sweeps + lb contractions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Improvement:
    """Result of a host improvement run; bounds only ever tighten."""
    lb: int
    ub: int
    ub_order: Optional[list]
    lb_moves: int = 0
    ub_moves: int = 0

    @property
    def closed(self) -> bool:
        return self.lb >= self.ub


_UB_STRATEGIES = ("min_degree", "min_fill")


def improve(g: Graph, lb: int = 0, ub: Optional[int] = None,
            ub_order: Optional[list] = None, *, rounds: int = 1,
            seed: int = 0, tracker=None) -> Improvement:
    """Run ``rounds`` improver rounds on the host; monotone by clamping.

    Each round draws one seeded randomized elimination sweep (strategy
    rotating min-degree / min-fill) and one seeded MMW contraction sweep.
    A pure function of (g, lb, ub, rounds, seed)."""
    tr = telemetry.get(tracker)
    if ub is None:
        ub = max(0, g.n - 1)
    out = Improvement(lb, ub, list(ub_order) if ub_order is not None else None)
    if g.n <= 1:
        return out
    for r in range(max(0, rounds)):
        if out.closed:
            break
        s = _round_seed(seed, r)
        strat = _UB_STRATEGIES[r % len(_UB_STRATEGIES)]
        w, o = bounds.randomized_order(g, s, strat)
        if w < out.ub:
            out.ub, out.ub_order = w, o
            out.ub_moves += 1
            tr.count(heur_ub_improvements=1)
        l = contraction_lb(g, s)
        if l > out.lb:
            out.lb = l
            out.lb_moves += 1
            tr.count(heur_lb_improvements=1)
    return out


# size gates: min-fill and the MMW oracle are cubic host loops, fine for
# exact-tier graphs and too slow at heuristic-only scale
_EXPENSIVE_N = 64


def quick_bounds(g: Graph, seed: int = 0) -> tuple:
    """Admission-time (lb, ub, ub_order) sized to the graph: the exact
    planner's bounds up to ``_EXPENSIVE_N`` vertices, degeneracy, clique
    and the min-degree sweep above."""
    n = g.n
    if n <= 1:
        return 0, 0, list(range(n))
    if n <= _EXPENSIVE_N:
        lb = bounds.lower_bound(g, seed=seed)
        ub, order = bounds.upper_bound(g, seed=seed)
    else:
        lb = max(bounds.degeneracy(g),
                 len(bounds.greedy_max_clique(g, tries=8, seed=seed)) - 1)
        ub, order = bounds._elimination_ub(g, "min_degree")
    return lb, min(ub, n - 1), order


# ---------------------------------------------------------------------------
# batched ub improver: one sweep covers the whole pool
# ---------------------------------------------------------------------------

def min_degree_sweep(adj: torch.Tensor, rank: torch.Tensor):
    """Randomized min-degree elimination of B graphs at once.

    adj (B, n, n) bool, rank (B, n) int32 (a permutation of 0..n-1 per
    graph) -> (width (B,) int32, order (B, n) int32).  Each step eliminates
    the live vertex of least ``deg * (n + 1) + rank`` (first index on a
    tie, as the reference's ``argmin``), raises the width to its degree,
    joins its neighbours into a clique and removes it.  The reference
    jits a ``fori_loop`` under ``vmap``; here the graph axis is written
    out and the n steps run from the host."""
    b, n, _ = adj.shape
    device = adj.device
    eye = torch.eye(n, dtype=torch.bool, device=device)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    rows = torch.arange(b, dtype=torch.int64, device=device)
    alive = torch.ones((b, n), dtype=torch.bool, device=device)
    width = torch.zeros((b,), dtype=torch.int32, device=device)
    order = torch.zeros((b, n), dtype=torch.int32, device=device)
    big = torch.full((b, n), 2 ** 30, dtype=torch.int32, device=device)
    rank = rank.to(torch.int32)
    for i in range(n):
        deg = adj.sum(dim=2, dtype=torch.int32)
        score = torch.where(alive, deg * (n + 1) + rank, big)
        v = torch.argmin(score, dim=1)
        width = torch.maximum(width, deg[rows, v])
        nb = adj[rows, v]
        adj = adj | (nb[:, :, None] & nb[:, None, :])
        keep = idx[None] != v[:, None]
        adj = adj & keep[:, :, None] & keep[:, None, :] & ~eye
        alive = alive & keep
        order[:, i] = v.to(torch.int32)
    return width, order


def pool_inputs(graphs: Sequence[Graph], seeds: Sequence[int]):
    """The sweep's inputs for a pool: (adj (B, n_pad, n_pad) bool, ranks
    (B, n_pad) int32) as numpy, every graph at the top of a shared
    ``n_pad = max(16, ceil16(n_max))`` and each rank
    ``RandomState(seed % (2^31 - 1)).permutation(n_pad)``."""
    n_max = max(g.n for g in graphs)
    n_pad = max(16, -(-n_max // 16) * 16)
    b = len(graphs)
    adjs = np.zeros((b, n_pad, n_pad), dtype=bool)
    ranks = np.zeros((b, n_pad), dtype=np.int32)
    for i, (g, s) in enumerate(zip(graphs, seeds)):
        adjs[i, :g.n, :g.n] = g.adj
        ranks[i] = np.random.RandomState(int(s) % (2 ** 31 - 1)) \
            .permutation(n_pad).astype(np.int32)
    return adjs, ranks


def ub_orders_async(graphs: Sequence[Graph], seeds: Sequence[int], *,
                    tracker=None, device=None) -> Any:
    """Launch one randomized min-degree sweep over the pool.

    Pads every graph to a shared n (isolated pad vertices eliminate first
    at degree 0 and cannot raise a width), runs ``min_degree_sweep`` on
    ``device`` (default ``cuda``) and returns an ``engine.DispatchHandle``
    whose ``result()`` yields one ``(width, order)`` per input graph, the
    order filtered back to the graph's real vertices.  Seeds pick the
    per-graph random tiebreak rank.  An empty pool is a done handle that
    does no work."""
    from . import backend as backend_lib
    from . import engine  # deferred: engine pulls in the backend registry

    tr = telemetry.get(tracker)
    if not graphs:
        return engine.DispatchHandle((), lambda host: [], _result=[],
                                     _done=True)
    global LAUNCHES
    device = backend_lib.resolve_device(device)
    adjs, ranks = pool_inputs(graphs, seeds)
    widths, orders = min_degree_sweep(torch.from_numpy(adjs).to(device),
                                      torch.from_numpy(ranks).to(device))
    LAUNCHES += 1
    tr.count(heur_dispatches=1, heur_lanes=len(graphs))
    ns = [g.n for g in graphs]
    event = None
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record()

    def finalize(host):
        ws, os_ = (x.numpy() for x in host)
        out = []
        for i, n in enumerate(ns):
            order = [int(v) for v in os_[i] if int(v) < n]
            out.append((int(ws[i]), order))
        return out

    return engine.DispatchHandle((widths, orders), finalize, tracker=tr,
                                 event=event)


# ---------------------------------------------------------------------------
# heuristic-only serving state (duck-types the scheduler's InstanceState)
# ---------------------------------------------------------------------------

class HeuristicState:
    """Bounds-only request state: no exact rungs, just improver rounds.

    Mirrors the slice of ``batch.InstanceState`` a scheduler touches
    (``run``/``result``/``bounds``/``partial``/``anytime_result``/
    ``improve_bounds``), with ``run`` pinned to None so no DP rung is ever
    packed for it.  Terminates when lb meets ub (then the result is exact:
    both sides are certificates) or when the round budget is spent, with
    ``exact=(lb == ub)``."""

    run = None  # never holds a DP ladder

    def __init__(self, g: Graph, solver_lib, *, seed: int = 0,
                 max_rounds: int = 16, tracker=None):
        self.g = g
        self.solver = solver_lib
        self.seed = int(seed)
        self.max_rounds = max(1, int(max_rounds))
        self.rounds_done = 0
        self.tracker = telemetry.get(tracker)
        self.t0 = time.time()
        self.result = None
        with self.tracker.time_block("heur_admit_s"):
            lb, ub, order = quick_bounds(g, seed=self.seed)
        self.lb, self.ub, self.ub_order = lb, ub, order
        if self.lb >= self.ub:
            self._finalize()

    def bounds(self) -> tuple:
        return self.lb, self.ub

    def partial(self) -> tuple:
        return 0, {}

    def max_n(self) -> int:
        return self.g.n

    def anytime_result(self, lb=None, ub=None):
        lb = self.lb if lb is None else max(lb, self.lb)
        ub = self.ub if ub is None else min(ub, self.ub)
        return self.solver.SolveResult(ub, lb == ub, lb, ub, 0,
                                       time.time() - self.t0,
                                       order=self.ub_order, per_k={})

    def improve_bounds(self, lb=None, ub=None, ub_order=None) -> dict:
        """Clamp in an improver result; monotone tighten only."""
        out = dict(lb_improved=False, ub_improved=False, rungs_skipped=0,
                   finished=False)
        if self.result is not None:
            return out
        if ub is not None and ub < self.ub and ub_order is not None:
            self.ub, self.ub_order = int(ub), list(ub_order)
            out["ub_improved"] = True
        if lb is not None and lb > self.lb:
            self.lb = min(int(lb), self.ub)
            out["lb_improved"] = True
        if self.lb >= self.ub:
            self._finalize()
            out["finished"] = True
        return out

    def step_done(self) -> bool:
        """Account one finished improver round; True once terminal."""
        self.rounds_done += 1
        if self.result is None and self.rounds_done >= self.max_rounds:
            self._finalize()
        return self.result is not None

    def _finalize(self):
        self.result = self.solver.SolveResult(
            self.ub, self.lb == self.ub, self.lb, self.ub, 0,
            time.time() - self.t0, order=self.ub_order, per_k={})
