"""Port parity: host planning (preprocess, bounds, plan_block, plan_capacity).

All of it is numpy on the host in both packages; the port keeps its own
copies, which must give identical blocks, vertex maps, bounds, orders,
disjoint-path matrices and capacities.
"""
import numpy as np
import pytest

import oracle
from repro.core import batch as ref_batch
from repro.core import bounds as ref_bounds
from repro.core import graph as ref_graph
from repro.core import preprocess as ref_preprocess
from repro.core import solver as ref_solver
from repro_torch.core import batch, bounds, graph, preprocess, solver

FAST = [name for name, _make, _tw in oracle.golden_cases()]
GNP = [(12, 0.3, 1), (16, 0.25, 2), (20, 0.2, 3), (14, 0.5, 4)]


def _port_graph(ref_g):
    return graph.Graph(ref_g.n, ref_g.adj.copy(), ref_g.name)


def _cases():
    out = [(name, oracle.make_graph(name)) for name in FAST]
    out += [(f"gnp_{n}_{p}_{s}", ref_graph.gnp(n, p, s)) for n, p, s in GNP]
    return out


CASES = _cases()
IDS = [c[0] for c in CASES]


def _same_block(a, b):
    assert a.g.packed().tobytes() == b.g.packed().tobytes()
    assert a.g.name == b.g.name
    np.testing.assert_array_equal(np.asarray(a.vmap), np.asarray(b.vmap))
    assert a.removed == b.removed and a.vertices == b.vertices


@pytest.mark.parametrize("name,ref_g", CASES, ids=IDS)
def test_preprocess_identical(name, ref_g):
    g = _port_graph(ref_g)
    want = ref_preprocess.preprocess(ref_g)
    got = preprocess.preprocess(g)
    assert got.lb == want.lb and got.removed == want.removed
    assert len(got.blocks) == len(want.blocks)
    for a, b in zip(got.blocks, want.blocks):
        _same_block(a, b)
    assert (preprocess.connected_components(g)
            == ref_preprocess.connected_components(ref_g))
    assert (preprocess.biconnected_blocks(g)
            == ref_preprocess.biconnected_blocks(ref_g))
    orders = [list(reversed(range(b.g.n))) for b in want.blocks]
    assert (preprocess.stitch_block_orders(got, orders)
            == ref_preprocess.stitch_block_orders(want, orders))


@pytest.mark.parametrize("name,ref_g", CASES, ids=IDS)
def test_block_plan_identical(name, ref_g):
    for ref_part in ref_preprocess.preprocess(ref_g).blocks:
        part = _port_graph(ref_part.g)
        want = ref_solver.plan_block(ref_part.g, use_clique=True,
                                     use_paths=True, start_k=None)
        got = solver.plan_block(part, use_clique=True, use_paths=True,
                                start_k=None)
        assert (got.clique, got.lb, got.ub, got.ub_order, got.k0,
                got.forced) == (want.clique, want.lb, want.ub,
                                want.ub_order, want.k0, want.forced)
        assert (got.paths is None) == (want.paths is None)
        if want.paths is not None:
            np.testing.assert_array_equal(got.paths, want.paths)
            for k in range(want.k0, want.ub):
                assert (got.graph_at(k).packed().tobytes()
                        == want.graph_at(k).packed().tobytes())
        assert (got.result is None) == (want.result is None)
        if want.result is not None:
            assert got.result == ref_like(want.result)


def ref_like(r):
    return solver.SolveResult(r.width, r.exact, r.lb, r.ub, r.expanded,
                              r.time_sec, r.order, r.per_k)


@pytest.mark.parametrize("name,ref_g", CASES[:6], ids=IDS[:6])
def test_bounds_identical(name, ref_g):
    g = _port_graph(ref_g)
    for seed in (0, 3):
        assert (bounds.greedy_max_clique(g, seed=seed)
                == ref_bounds.greedy_max_clique(ref_g, seed=seed))
        assert (bounds.lower_bound(g, seed=seed)
                == ref_bounds.lower_bound(ref_g, seed=seed))
        assert (bounds.upper_bound(g, seed=seed, restarts=2)
                == ref_bounds.upper_bound(ref_g, seed=seed, restarts=2))
    assert bounds.mmw_root_bound(g) == ref_bounds.mmw_root_bound(ref_g)


def test_plan_start_k_forced_identical():
    ref_g = ref_graph.REGISTRY["petersen"]()
    g = _port_graph(ref_g)
    for start_k in (0, 3, 4):
        want = ref_solver.plan_block(ref_g, use_clique=True, use_paths=False,
                                     start_k=start_k)
        got = solver.plan_block(g, use_clique=True, use_paths=False,
                                start_k=start_k)
        assert (got.k0, got.forced, got.lb) == (want.k0, want.forced,
                                                want.lb)
        for k in range(want.k0, want.ub):
            assert got.exact_at(k, False) == want.exact_at(k, False)


@pytest.mark.parametrize("n", [0, 1, 2, 5, 10, 14, 17, 25, 36, 49, 100])
def test_plan_capacity_identical(n):
    for block in (32, 128, 2048, 1 << 15):
        assert (batch.plan_capacity(n, block=block)
                == ref_batch.plan_capacity(n, block=block))
    assert (batch.plan_capacity(n, 1, lanes=8, budget_bytes=8 * 1024 * 4)
            == ref_batch.plan_capacity(n, 1, lanes=8,
                                       budget_bytes=8 * 1024 * 4))
    assert (batch.plan_capacity(n, cap_max=1000)
            == ref_batch.plan_capacity(n, cap_max=1000))
    assert batch.DEFAULT_CAP == ref_batch.DEFAULT_CAP


@pytest.mark.parametrize("n,w,lanes", [(14, 1, 8), (10, None, 1),
                                       (40, 2, 4)])
def test_plan_capacity_auto_budget_equals_reference(n, w, lanes):
    """``budget_bytes="auto"`` reads the device's free memory; on the CPU
    there is none to read, so the plan is the state-space bound alone, as
    in the reference (``plan_capacity(14, 1, lanes=8, "auto")`` is
    65536)."""
    got = batch.plan_capacity(n, w, lanes=lanes, budget_bytes="auto")
    assert got == ref_batch.plan_capacity(n, w, lanes=lanes,
                                          budget_bytes="auto")
    assert got == batch.plan_capacity(n, w, lanes=lanes)
    if (n, w, lanes) == (14, 1, 8):
        assert got == 65536


def test_device_memory_budget_is_none_without_a_card():
    from repro_torch.core import backend
    assert backend.device_memory_budget(device="cpu") is None
    assert backend.device_memory_budget(0.25, device="cpu") is None
