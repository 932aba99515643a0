"""Port parity: ``repro_torch.core.solver.solve`` end to end on the CPU.

Width, ``exact``, ``lb``, ``ub``, ``expanded`` and ``per_k`` must equal
``repro.core.solver.solve`` on every non-slow golden instance and on
small ``tw_oracle`` graphs; reconstructed orders replay at or below the
width; the engines agree.  The CLI, the registry and import hygiene are in
``test_torch_launch.py``.
"""
import numpy as np
import pytest
import torch

import oracle
from repro.core import graph as ref_graph
from repro.core import solver as ref_solver
from repro_torch.core import graph, solver, telemetry

GOLDEN = oracle.golden_cases()


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


def _summary(r):
    return (r.width, r.exact, r.lb, r.ub, r.expanded, r.per_k)


@pytest.mark.parametrize("name,make,tw", GOLDEN, ids=[c[0] for c in GOLDEN])
def test_golden_solve_matches_reference(name, make, tw):
    g = make()
    want = ref_solver.solve(g)
    tr = telemetry.Tracker()
    got = solver.solve(_port_graph(g), device="cpu", tracker=tr)
    assert _summary(got) == _summary(want)
    assert got.width == tw
    snap = tr.snapshot()
    if got.expanded:
        assert snap["counters"]["expanded"] == got.expanded
        assert snap["counters"]["rungs_decided"] >= 1
        assert snap["counters"]["dispatches"] >= 1
        assert snap["counters"]["host_syncs"] >= 1
        assert "rung_s" in snap["timings"]
        assert snap["gauges"]["frontier_cap"] >= 32
        assert "frontier_peak_rows" in snap["gauges"]


@pytest.mark.parametrize("seed", range(6))
def test_oracle_graphs_match_reference_and_tw_oracle(seed):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(6, 11))
    g = ref_graph.gnp(n, float(rng.choice([0.25, 0.4, 0.6])), seed)
    want = ref_solver.solve(g, use_preprocess=False)
    got = solver.solve(_port_graph(g), use_preprocess=False, device="cpu")
    assert _summary(got) == _summary(want)
    assert got.width == oracle.tw_oracle(g)


def test_overflow_solve_matches_reference():
    g = ref_graph.gnp(20, 0.3, 3)
    kw = dict(cap=128, block=64, use_preprocess=False)
    want = ref_solver.solve(g, **kw)
    got = solver.solve(_port_graph(g), device="cpu", **kw)
    assert _summary(got) == _summary(want)
    assert any(v["inexact"] for v in got.per_k.values())


@pytest.mark.parametrize("name", ["petersen", "myciel3", "grid4x5",
                                  "tree20_7"])
def test_reconstruct_orders_replay_within_width(name):
    g = oracle.make_graph(name)
    pg = _port_graph(g)
    res = solver.solve(pg, reconstruct=True, device="cpu")
    assert res.order is not None and oracle.order_is_valid(pg, res.order)
    assert solver.order_width(pg, res.order) <= res.width
    want = ref_solver.solve(g, reconstruct=True)
    assert _summary(res) == _summary(want)


def test_host_engine_matches_fused():
    g = _port_graph(oracle.make_graph("myciel3"))
    a = solver.solve(g, engine="host", device="cpu")
    b = solver.solve(g, engine="fused", device="cpu")
    assert _summary(a) == _summary(b)
