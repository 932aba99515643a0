"""The disjoint-paths matrix off the card: the paths kernel's plain version
against the host function, and block planning's routing on the host.

``paths_matrix_ref`` (``kernels/paths/ops.py``) runs the kernel's
augmenting search in PyTorch; it must equal
``bounds.disjoint_paths_matrix`` (one max-flow per pair) bit for bit on
every graph and cap.  ``plan_block`` without a device, or on the CPU,
keeps the host function and never counts ``paths_kernel_blocks``.  The
kernel itself is held to the host function on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bitset, bounds, graph, solver, telemetry
from repro_torch.kernels import paths as paths_kernel

TABLE1 = ["myciel3", "myciel4", "queen5_5", "queen6_6", "petersen",
          "desargues", "mcgee", "dyck", "grid6x6"]
CAPS = ["0", "1", "below_min_degree", "ub", "64"]


def _cap(kind: str, g) -> int:
    if kind == "below_min_degree":
        return max(0, int(g.degrees().min()) - 1) if g.n else 0
    if kind == "ub":
        return bounds.upper_bound(g)[0]
    return int(kind)


def _gnp_cases(count=60, seed=2027):
    """Seeded G(n, p), n 2..40, p 0.05..0.95, each at one cap kind in
    turn."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(count):
        n = int(rng.randint(2, 41))
        p = float(np.round(rng.uniform(0.05, 0.95), 2))
        out.append((f"gnp_{n}_{p}_{i}", (n, p, i), CAPS[i % len(CAPS)]))
    return out


def _two_cliques():
    a = np.zeros((8, 8), dtype=bool)
    a[:4, :4] = a[4:, 4:] = True
    np.fill_diagonal(a, False)
    return graph.Graph(8, a, "two_k4")


def _path_and_isolated():
    return graph.from_edges(6, [(0, 1), (1, 2), (2, 3), (3, 4)],
                            "path5_isolated")


EDGE_GRAPHS = {
    "empty_0": lambda: graph.Graph(0, np.zeros((0, 0), dtype=bool), "e0"),
    "empty_1": lambda: graph.Graph(1, np.zeros((1, 1), dtype=bool), "e1"),
    "empty_5": lambda: graph.Graph(5, np.zeros((5, 5), dtype=bool), "e5"),
    "k2": lambda: graph.complete(2),
    "k7": lambda: graph.complete(7),
    "k16": lambda: graph.complete(16),
    "two_k4": _two_cliques,
    "path5_isolated": _path_and_isolated,
}

CASES = ([(f"{name}-{cap}", ("registry", name), cap)
          for name in TABLE1 for cap in CAPS]
         + [(f"{name}-{cap}", ("edge", name), cap)
            for name in EDGE_GRAPHS for cap in CAPS]
         + [(f"{name}-{cap}", ("gnp", args), cap)
            for name, args, cap in _gnp_cases()])


def _graph(kind, arg):
    if kind == "registry":
        return graph.REGISTRY[arg]()
    if kind == "edge":
        return EDGE_GRAPHS[arg]()
    return graph.gnp(*arg)


@pytest.mark.parametrize("source,cap_kind", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_plain_version_equals_host_function(source, cap_kind):
    g = _graph(*source)
    cap = _cap(cap_kind, g)
    want = bounds.disjoint_paths_matrix(g, cap=cap)
    got = paths_kernel.paths_matrix_ref(bitset.to_words(g.packed(), "cpu"),
                                        cap, n=g.n)
    assert got.dtype == torch.int32 and got.shape == (g.n, g.n)
    got = got.numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, got.T)
    assert not np.diagonal(got).any()


def test_plain_version_in_small_pair_chunks():
    """Pairs split over many steps give the same matrix."""
    g = graph.gnp(17, 0.4, 5)
    adj = bitset.to_words(g.packed(), "cpu")
    want = bounds.disjoint_paths_matrix(g, cap=6)
    for chunk in (5, 100):
        got = paths_kernel.paths_matrix_ref(adj, 6, n=g.n, chunk=chunk)
        np.testing.assert_array_equal(got.numpy(), want)


def test_paths_matrix_on_the_cpu_takes_the_plain_version():
    g = graph.REGISTRY["petersen"]()
    adj = bitset.to_words(g.packed(), "cpu")
    before = paths_kernel.ops.LAUNCHES
    got = paths_kernel.paths_matrix(adj, 5, n=g.n)
    assert paths_kernel.ops.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(),
                                  bounds.disjoint_paths_matrix(g, cap=5))


def test_paths_matrix_checks_its_operand():
    adj = bitset.to_words(graph.REGISTRY["petersen"]().packed(), "cpu")
    with pytest.raises(ValueError):
        paths_kernel.paths_matrix(adj, 5, n=11)
    with pytest.raises(ValueError):
        paths_kernel.paths_matrix(torch.zeros((40, 1), dtype=torch.int32),
                                  5, n=40)
    with pytest.raises(TypeError):
        paths_kernel.paths_matrix(adj.to(torch.int64), 5, n=10)


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("name", ["queen5_5", "dyck", "grid6x6"])
def test_plan_block_on_the_host_keeps_the_host_function(name, device):
    """Without a card the plan is today's: the host function's matrix, and
    no block counted as the kernel's; the matrix is timed as a
    ``paths_s`` span inside ``plan_s``."""
    g = graph.REGISTRY[name]()
    tr = telemetry.Tracker()
    got = solver.plan_block(g, use_clique=True, use_paths=True,
                            start_k=None, tracker=tr, device=device)
    want = solver.plan_block(g, use_clique=True, use_paths=True,
                             start_k=None, tracker=telemetry.Tracker())
    assert (got.clique, got.lb, got.ub, got.ub_order, got.k0,
            got.forced) == (want.clique, want.lb, want.ub, want.ub_order,
                            want.k0, want.forced)
    np.testing.assert_array_equal(got.paths,
                                  bounds.disjoint_paths_matrix(g,
                                                               cap=got.ub))
    assert tr.value("paths_kernel_blocks") == 0
    timings = tr.snapshot()["timings"]
    assert timings["paths_s"]["calls"] == 1
    assert timings["plan_s"]["total_s"] >= timings["paths_s"]["total_s"]
    assert "read_s" not in timings


def test_solve_on_the_cpu_counts_no_kernel_block():
    tr = telemetry.Tracker()
    res = solver.solve(graph.REGISTRY["queen5_5"](), device="cpu",
                       tracker=tr)
    assert res.width == 18 and res.exact
    assert tr.value("paths_kernel_blocks") == 0
    assert tr.snapshot()["timings"]["paths_s"]["calls"] == 1
