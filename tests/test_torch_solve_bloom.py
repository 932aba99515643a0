"""Port parity: whole solves in Bloom mode, alone and as the paper's
configuration with the MMW prune (``mode="bloom", use_mmw=True``).

Width, ``exact``, ``lb``, ``ub``, ``expanded`` and ``per_k`` must equal
``repro.core.solver.solve`` with the same arguments on every non-slow
golden instance.  Both run the byte-per-bit filter that queries a batch
before inserting it (the ``jax`` and ``torch`` backends' semantics).
"""
import pytest
import torch

import oracle
from repro.core import solver as ref_solver
from repro_torch.core import graph, solver

GOLDEN = oracle.golden_cases()
CONFIGS = {"bloom": dict(mode="bloom"),
           "bloom+mmw": dict(mode="bloom", use_mmw=True)}


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


def test_small_filter_and_host_engine_match_reference():
    """A 4096-bit filter makes false positives likely; the host engine
    must still agree with the reference's host engine."""
    g = oracle.make_graph("myciel3")
    kw = dict(mode="bloom", use_mmw=True, m_bits=4096, k_hashes=3,
              engine="host", use_preprocess=False)
    want = ref_solver.solve(g, **kw)
    got = solver.solve(graph.Graph(g.n, g.adj.copy(), g.name), device="cpu",
                       **kw)
    assert _summary(got) == _summary(want)
