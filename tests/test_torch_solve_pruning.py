"""Port parity: whole solves with the pruning rules, ``use_mmw=True`` and
``use_simplicial=True`` each alone, in exact sort mode.

Width, ``exact``, ``lb``, ``ub``, ``expanded`` and ``per_k`` must equal
``repro.core.solver.solve`` with the same arguments on every non-slow
golden instance; reconstructed orders replay within the width.
"""
import pytest
import torch

import oracle
from repro.core import solver as ref_solver
from repro_torch.core import graph, solver

GOLDEN = oracle.golden_cases()
CONFIGS = {"mmw": dict(use_mmw=True),
           "simplicial": dict(use_simplicial=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Test workers run side by side; one torch thread each keeps them from
    oversubscribing the CPU (the results do not depend on it)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _summary(r):
    return (r.width, r.exact, r.lb, r.ub, r.expanded, r.per_k)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("name,make,tw", GOLDEN, ids=[c[0] for c in GOLDEN])
def test_golden_solve_matches_reference(name, make, tw, config):
    g = make()
    kw = CONFIGS[config]
    want = ref_solver.solve(g, **kw)
    got = solver.solve(graph.Graph(g.n, g.adj.copy(), g.name), device="cpu",
                       **kw)
    assert _summary(got) == _summary(want)
    assert got.width == tw


@pytest.mark.parametrize("config", list(CONFIGS))
def test_reconstruct_orders_replay_within_width(config):
    g = oracle.make_graph("petersen")
    pg = graph.Graph(g.n, g.adj.copy(), g.name)
    res = solver.solve(pg, reconstruct=True, device="cpu", **CONFIGS[config])
    assert res.order is not None and oracle.order_is_valid(pg, res.order)
    assert solver.order_width(pg, res.order) <= res.width == 4
