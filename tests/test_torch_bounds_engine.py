"""Port parity: the anytime bounds engine (``repro_torch.core.bounds_engine``).

Every improver draws from numpy's ``RandomState`` in the reference's
order, so bounds, orders and widths must equal ``repro.core.bounds_engine``
seed for seed: the contraction lower bound, the host improvement loop,
the admission bounds on both sides of ``_EXPENSIVE_N``, the batched
min-degree sweep (a jitted vmapped ``fori_loop`` in the reference, a
batched torch function here), the bounds-only request state, and
``solve(heuristics=N, seed=s)``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from repro.core import bounds_engine as ref_be
from repro.core import graph as ref_graph
from repro.core import solver as ref_solver
from repro.core import telemetry as ref_telemetry
from repro_torch.core import bounds_engine, graph, solver, telemetry

FAST = dict(cap=1 << 12, block=32)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Test workers run side by side; one torch thread each keeps them from
    oversubscribing the CPU (the results do not depend on it)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_graph(g):
    return graph.Graph(g.n, g.adj.copy(), g.name)


def _graphs():
    """Oracle graphs, seeded gnp below ``_EXPENSIVE_N`` and two above."""
    gs = [oracle.make_graph(name)
          for name in ("petersen", "myciel3", "myciel4", "queen5_5")]
    gs += [ref_graph.gnp(n, p, seed) for n, p, seed in
           [(9, 0.5, 1), (14, 0.3, 2), (30, 0.2, 3), (70, 0.08, 4),
            (90, 0.05, 5)]]
    return gs


GRAPHS = _graphs()
IDS = [g.name for g in GRAPHS]


@pytest.mark.parametrize("g", GRAPHS, ids=IDS)
def test_contraction_lb_and_quick_bounds_match_reference(g):
    pg = _port_graph(g)
    for seed in (0, 1, 7, 12345):
        assert bounds_engine.contraction_lb(pg, seed) == \
            ref_be.contraction_lb(g, seed), seed
        assert bounds_engine.quick_bounds(pg, seed=seed) == \
            ref_be.quick_bounds(g, seed=seed), seed
    assert (g.n > bounds_engine._EXPENSIVE_N) == (g.n > ref_be._EXPENSIVE_N)


@pytest.mark.parametrize("g", GRAPHS, ids=IDS)
def test_improve_matches_reference(g):
    """Bounds, order and move counts after 1..6 rounds from the admission
    bounds and from open bounds, with the improvement counters."""
    pg = _port_graph(g)
    lb, ub, order = ref_be.quick_bounds(g, seed=3)
    for rounds, seed, start in [(1, 0, (lb, ub, order)), (6, 11, (lb, ub,
                                order)), (4, 5, (0, None, None))]:
        ref_tr, port_tr = ref_telemetry.Tracker(), telemetry.Tracker()
        want = ref_be.improve(g, *start, rounds=rounds, seed=seed,
                              tracker=ref_tr)
        got = bounds_engine.improve(pg, *start, rounds=rounds, seed=seed,
                                    tracker=port_tr)
        assert (got.lb, got.ub, got.ub_order, got.lb_moves, got.ub_moves,
                got.closed) == (want.lb, want.ub, want.ub_order,
                                want.lb_moves, want.ub_moves, want.closed)
        assert port_tr.snapshot()["counters"] == \
            ref_tr.snapshot()["counters"]
    assert bounds_engine._round_seed(12, 3) == ref_be._round_seed(12, 3)


@pytest.mark.parametrize("n_pad", [16, 48])
def test_min_degree_sweep_matches_reference_kernel(n_pad):
    """Random (B, n, n) adjacency and rank permutations straight into both
    sweeps: widths and orders equal."""
    rng = np.random.RandomState(n_pad)
    b = 6
    adj = rng.rand(b, n_pad, n_pad) < rng.uniform(0.05, 0.5, (b, 1, 1))
    adj = np.triu(adj, 1)
    adj = adj | adj.transpose(0, 2, 1)
    ranks = np.stack([rng.permutation(n_pad) for _ in range(b)]).astype(
        np.int32)
    want_w, want_o = ref_be._kernel_cached(n_pad)(jnp.asarray(adj),
                                                  jnp.asarray(ranks))
    got_w, got_o = bounds_engine.min_degree_sweep(torch.from_numpy(adj),
                                                  torch.from_numpy(ranks))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))


def test_ub_orders_async_matches_reference_on_a_mixed_pool():
    """Mixed n (padded to a shared n), several seeds: widths and orders per
    (graph, seed), orders that replay to their width, and the counters."""
    pool = GRAPHS[:7]
    seeds = [3, 4, 5, 0, 9, 2 ** 31 + 5, 17]
    ref_tr, port_tr = ref_telemetry.Tracker(), telemetry.Tracker()
    want = ref_be.ub_orders_async(pool, seeds, tracker=ref_tr).result()
    h = bounds_engine.ub_orders_async([_port_graph(g) for g in pool], seeds,
                                      tracker=port_tr, device="cpu")
    got = h.result()
    assert got == want
    for g, (w, order) in zip(pool, got):
        assert oracle.order_is_valid(g, order)
        assert solver.order_width(_port_graph(g), order) == w
    keys = ("heur_dispatches", "heur_lanes")
    assert {k: port_tr.snapshot()["counters"][k] for k in keys} == \
        {k: ref_tr.snapshot()["counters"][k] for k in keys} == \
        {"heur_dispatches": 1, "heur_lanes": len(pool)}


def test_ub_orders_async_empty_pool_is_a_done_noop():
    before = bounds_engine.LAUNCHES
    h = bounds_engine.ub_orders_async([], [], device="cpu")
    assert h.ready() and h.result() == [] == \
        ref_be.ub_orders_async([], []).result()
    assert bounds_engine.LAUNCHES == before


@pytest.mark.parametrize("name,seed,rounds", [
    ("mcgee", 5, 4), ("petersen", 0, 3), ("queen5_5", 2, 6),
    ("desargues", 1, 8)])
def test_heuristic_state_matches_reference(name, seed, rounds):
    """The same improver rounds fed to both states (the batched sweep for
    ub, the contraction sweep for lb): the same bounds after every round
    and the same final result."""
    g = ref_graph.REGISTRY[name]()
    pg = _port_graph(g)
    ref = ref_be.HeuristicState(g, ref_solver, seed=seed, max_rounds=rounds)
    port = bounds_engine.HeuristicState(pg, solver, seed=seed,
                                        max_rounds=rounds)
    assert port.bounds() == ref.bounds() and port.run is None
    assert port.partial() == ref.partial() == (0, {})
    for r in range(rounds + 1):
        if ref.result is not None:
            break
        s = ref_be._round_seed(seed, r)
        [(w, o)] = ref_be.ub_orders_async([g], [s]).result()
        [(pw, po)] = bounds_engine.ub_orders_async([pg], [s],
                                                   device="cpu").result()
        assert (pw, po) == (w, o)
        lb = ref_be.contraction_lb(g, s)
        assert bounds_engine.contraction_lb(pg, s) == lb
        assert port.improve_bounds(lb=lb, ub=pw, ub_order=po) == \
            ref.improve_bounds(lb=lb, ub=w, ub_order=o)
        assert port.step_done() == ref.step_done()
        assert port.bounds() == ref.bounds()
    a, b = port.result, ref.result
    assert (a.width, a.exact, a.lb, a.ub, a.expanded, a.order, a.per_k) == \
        (b.width, b.exact, b.lb, b.ub, b.expanded, b.order, b.per_k)
    any_a = port.anytime_result(lb=0, ub=g.n)
    any_b = ref.anytime_result(lb=0, ub=g.n)
    assert (any_a.width, any_a.exact, any_a.lb, any_a.ub) == \
        (any_b.width, any_b.exact, any_b.lb, any_b.ub)


@pytest.mark.parametrize("name,kw", [
    ("petersen", dict(heuristics=8, seed=0, start_k=0)),
    ("petersen", dict(heuristics=3, seed=4)),
    ("myciel3", dict(heuristics=8, seed=1, start_k=0)),
    ("queen5_5", dict(heuristics=4, seed=0)),
    ("queen5_5", dict(heuristics=8, seed=3, mode="bloom", use_mmw=True)),
    ("myciel4", dict(heuristics=2, seed=9, use_preprocess=False))])
def test_solve_with_heuristics_matches_reference(name, kw):
    g = oracle.make_graph(name)
    want = ref_solver.solve(g, **FAST, **kw)
    got = solver.solve(_port_graph(g), device="cpu", **FAST, **kw)
    assert (got.width, got.exact, got.lb, got.ub, got.expanded,
            got.per_k) == (want.width, want.exact, want.lb, want.ub,
                           want.expanded, want.per_k)


def test_heuristics_tighten_the_ladder_without_changing_the_verdict():
    g = _port_graph(oracle.make_graph("petersen"))
    a = solver.solve(g, start_k=0, device="cpu", **FAST)
    b = solver.solve(g, start_k=0, heuristics=8, device="cpu", **FAST)
    assert (a.width, a.exact) == (b.width, b.exact)
    assert b.expanded < a.expanded
    plan = solver.plan_block(g, use_clique=True, use_paths=True,
                             start_k=None, heuristics=8, seed=0)
    ref_plan = ref_solver.plan_block(oracle.make_graph("petersen"),
                                     use_clique=True, use_paths=True,
                                     start_k=None, heuristics=8, seed=0)
    assert (plan.lb, plan.ub, plan.ub_order, plan.k0, plan.forced) == \
        (ref_plan.lb, ref_plan.ub, ref_plan.ub_order, ref_plan.k0,
         ref_plan.forced)
