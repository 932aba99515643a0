"""Port parity: the closure schedules of the ``torch`` backend (the
paper's Table-6 sweep, ``repro.core.components``).

``while``, ``linear`` and ``matmul`` on the cases of
``tests/test_core_components.py`` (random gnp, word-boundary graphs,
S-chains, the DFS oracle): degrees, reach and closures bit-identical to
the reference's ``jax`` functions, and ``solve(g, schedule=s)`` equal to
the reference's for all four schedules.  The ``cuda`` backend keeps the
static doubling schedule and rejects the others before any work, in the
reference's terms for its Pallas backend.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from repro.core import bitset as ref_bitset
from repro.core import components as ref_components
from repro.core import expand as ref_expand
from repro.core import graph as ref_graph
from repro.core import solver as ref_solver
from repro_torch.core import (backend, bitset, components, expand, graph,
                              solver)

SCHEDULES = ("doubling", "while", "linear", "matmul")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Test workers run side by side; one torch thread each keeps them from
    oversubscribing the CPU (the results do not depend on it)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_degrees(g, states, schedule):
    adj = jnp.asarray(g.packed())
    if schedule == "matmul":
        fn = lambda s: ref_components.eliminated_degrees_matmul(  # noqa: E731
            adj, s, g.n)
    else:
        fn = lambda s: ref_components.eliminated_degrees(  # noqa: E731
            adj, s, g.n, schedule=schedule)
    deg, reach = jax.jit(jax.vmap(fn))(jnp.asarray(states))
    return np.asarray(deg), np.asarray(reach)


def _port_degrees(g, states, schedule):
    adj = bitset.to_words(g.packed(), "cpu")
    s = bitset.to_words(states, "cpu")
    if schedule == "matmul":
        deg, reach = components.eliminated_degrees_matmul(adj, s, g.n)
    else:
        deg, reach = components.eliminated_degrees(adj, s, g.n,
                                                   schedule=schedule)
    return deg.numpy(), bitset.from_words(reach)


def _check(g, sets):
    states = ref_bitset.np_pack(sets, g.n)
    adjb = [list(map(bool, row)) for row in g.adj]
    for schedule in SCHEDULES:
        want_deg, want_reach = _ref_degrees(g, states, schedule)
        got_deg, got_reach = _port_degrees(g, states, schedule)
        assert np.array_equal(got_deg, want_deg), schedule
        assert np.array_equal(got_reach, want_reach), schedule
        if schedule == "while":    # degrees are equal across schedules
            for b, s in enumerate(sets):
                for v in range(g.n):
                    if v not in s:
                        assert got_deg[b, v] == ref_expand.degree_oracle(
                            adjb, set(s), v), (v, s)
        if schedule == "matmul":
            continue
        want_z = jax.jit(jax.vmap(lambda s: ref_components.closure(
            jnp.asarray(g.packed()), s, g.n, schedule=schedule)))(
                jnp.asarray(states))
        got_z = components.closure(bitset.to_words(g.packed(), "cpu"),
                                   bitset.to_words(states, "cpu"), g.n,
                                   schedule=schedule, unroll=4)
        assert np.array_equal(bitset.from_words(got_z), np.asarray(want_z))


@pytest.mark.parametrize("seed", range(8))
def test_random_gnp(seed):
    rng = random.Random(seed)
    n = rng.randint(2, 48)
    g = ref_graph.gnp(n, rng.choice([0.08, 0.25, 0.5, 0.9]), seed)
    sets = [set(rng.sample(range(n), rng.randint(0, n - 1)))
            for _ in range(4)]
    _check(g, sets)


@pytest.mark.parametrize("n", [31, 32, 33, 63, 64, 65])
def test_word_boundary_graphs(n):
    _check(ref_graph.cycle(n), [{1, 2, 3, n - 2}, set(range(0, n - 1, 2))])


def test_path_through_s_chain_and_empty_s():
    _check(ref_graph.path(5), [{1, 2, 3}, set()])
    g = ref_graph.queen(4)
    deg, _ = _port_degrees(g, np.zeros((1, g.w), np.uint32), "while")
    assert np.array_equal(deg[0], g.degrees())


def test_matmul_route_in_expand_block():
    """``expand_block(schedule="matmul")`` takes the float formulation,
    whose reach is Q(S, v), as the reference's does."""
    g = ref_graph.grid(4, 4)
    states = ref_bitset.np_pack([set(), {0, 1}, {5}, {2}], g.n)
    valid = np.array([True, True, True, False])
    allowed = np.asarray(ref_bitset.full(g.n))
    want = ref_expand.expand_block(
        jnp.asarray(g.packed()), jnp.asarray(states), jnp.asarray(valid),
        jnp.int32(3), jnp.asarray(allowed), g.n, schedule="matmul")
    got = expand.expand_block(
        bitset.to_words(g.packed(), "cpu"), bitset.to_words(states, "cpu"),
        torch.from_numpy(valid), 3, bitset.to_words(allowed, "cpu"), g.n,
        schedule="matmul")
    assert np.array_equal(bitset.from_words(got[0]), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    live = valid.nonzero()[0]      # the port leaves invalid rows at 0
    assert np.array_equal(got[2].numpy()[live], np.asarray(want[2])[live])
    assert np.array_equal(bitset.from_words(got[3])[live],
                          np.asarray(want[3])[live])


def test_eye_matches_reference():
    for n in (1, 31, 32, 33, 100):
        w = ref_bitset.n_words(n)
        assert np.array_equal(components._eye_np(n, w),
                              ref_components._eye_np(n, w))
        assert torch.equal(components._eye_words(n, w),
                           bitset.eye_words(n, w, "cpu"))


def test_unknown_schedule_is_rejected_as_reference():
    adj = bitset.to_words(ref_graph.path(4).packed(), "cpu")
    s = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown schedule 'matmul'"):
        components.closure(adj, s, 4, schedule="matmul")
    with pytest.raises(ValueError, match="unknown schedule 'nope'"):
        components.eliminated_degrees(adj, s, 4, schedule="nope")


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name,kw", [
    ("queen5_5", {}), ("petersen", dict(use_mmw=True, use_simplicial=True))],
    ids=["defaults", "mmw+simplicial"])
def test_solve_matches_reference(schedule, name, kw):
    g = oracle.make_graph(name)
    want = ref_solver.solve(g, schedule=schedule, backend="jax", **kw)
    got = solver.solve(graph.Graph(g.n, g.adj.copy(), g.name),
                       schedule=schedule, device="cpu", **kw)
    assert (got.width, got.exact, got.lb, got.ub, got.expanded,
            got.per_k) == (want.width, want.exact, want.lb, want.ub,
                           want.expanded, want.per_k)


@pytest.mark.parametrize("schedule", ["while", "linear", "matmul"])
def test_cuda_backend_keeps_doubling(schedule):
    g = graph.REGISTRY["petersen"]()
    with pytest.raises(backend.BackendCapabilityError,
                       match="static doubling fixpoint"):
        solver.solve(g, schedule=schedule, backend="cuda", device="cpu")
    backend.validate("torch", schedule=schedule)
    from repro.core import backend as ref_backend
    with pytest.raises(ref_backend.BackendCapabilityError,
                       match="static doubling fixpoint"):
        ref_backend.validate("pallas", schedule=schedule)
