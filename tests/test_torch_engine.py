"""Port parity: the wavefront engine, level by level.

Both packages are seeded with the same numpy frontier (``from_numpy`` on
the port's side) and run ``fused_decide(max_levels=...)``; the resulting
frontiers must be bit-identical: every row of the buffer in order,
``count`` and ``dropped``.  Cases cover the ``SMALL_BLOCK`` branch, the
cross-chunk dedup, a forced overflow and the host engine's adaptive
block.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import bitset as ref_bitset
from repro.core import engine as ref_engine
from repro.core import frontier as ref_frontier
from repro.core import graph as ref_graph
from repro.core import solver as ref_solver
from repro_torch.core import bitset, engine, frontier, solver, telemetry

REF_KW = dict(mode="sort", use_mmw=False, m_bits=1 << 10, k_hashes=3,
              schedule="doubling", backend="jax")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Test workers run side by side; one torch thread each keeps them from
    oversubscribing the CPU (the results do not depend on it)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(g, clique):
    adj = g.packed()
    allowed = ref_bitset.np_allowed(g.n, clique)
    return adj, allowed


def _ref_step(adj, allowed, k, target, fr_np, *, n, cap, block, levels,
              flags=None):
    states, count, dropped = fr_np
    fr = ref_frontier.Frontier(jnp.asarray(states), jnp.int32(count),
                               jnp.int32(dropped))
    feas, inexact, expanded, out = ref_engine.fused_decide(
        jnp.asarray(adj), jnp.asarray(allowed), k, target, n=n, cap=cap,
        block=block, fr=fr, max_levels=levels, **{**REF_KW, **(flags or {})})
    return (feas, inexact, expanded,
            (np.asarray(out.states), int(out.count), int(out.dropped)))


def _port_step(adj, allowed, k, target, fr_np, *, n, cap, block, levels,
               flags=None):
    fr = frontier.from_numpy(*fr_np, device="cpu")
    feas, inexact, expanded, out = engine.fused_decide(
        bitset.to_words(adj, "cpu"), bitset.to_words(allowed, "cpu"), k,
        target, n=n, cap=cap, block=block, fr=fr, max_levels=levels,
        tracker=telemetry.NULL, **(flags or {}))
    return feas, inexact, expanded, out.to_numpy()


def _assert_same(got, want):
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3][0], want[3][0])
    assert got[3][1:] == want[3][1:]


def _walk(g, k, clique, *, cap, block, max_steps=None, flags=None):
    """Step both engines one level at a time from the reference's own
    frontiers; returns the per-level (count, dropped) seen.  ``flags``
    sets the dedup mode, the pruning rules and the filter size."""
    adj, allowed = _inputs(g, clique)
    n, w = g.n, ref_bitset.n_words(g.n)
    target = n - max(k + 1, len(clique))
    fr_np = (np.zeros((cap, w), dtype=np.uint32), 1, 0)
    seen = []
    for _ in range(min(target, max_steps or target)):
        want = _ref_step(adj, allowed, k, target, fr_np, n=n, cap=cap,
                         block=block, levels=1, flags=flags)
        got = _port_step(adj, allowed, k, target, fr_np, n=n, cap=cap,
                         block=block, levels=1, flags=flags)
        _assert_same(got, want)
        seen.append((fr_np[1], want[3][1], want[3][2]))
        fr_np = want[3]
        if fr_np[1] == 0:
            break
    return seen


def test_levels_default_geometry_small_and_wide_chunks():
    g = ref_graph.REGISTRY["queen5_5"]()
    seen = _walk(g, 17, [], cap=1 << 13, block=256)
    counts = [c for c, _, _ in seen]
    # both the SMALL_BLOCK branch (<= 128 rows) and multi-chunk levels
    # with the cross-chunk dedup (> 256 rows) were exercised
    assert min(counts) <= engine.SMALL_BLOCK
    assert max(counts) > 256


FLAG_CONFIGS = {
    "bloom": dict(mode="bloom", m_bits=1 << 16, k_hashes=17),
    "mmw": dict(use_mmw=True),
    "simplicial": dict(use_simplicial=True),
    "bloom+mmw": dict(mode="bloom", use_mmw=True, m_bits=1 << 16,
                      k_hashes=17),
}


@pytest.mark.parametrize("config", list(FLAG_CONFIGS))
def test_levels_under_each_flag(config):
    """Per-level frontiers with Bloom dedup and the pruning rules, over
    small and multi-chunk levels (Bloom mode skips the cross-chunk
    dedup)."""
    g = ref_graph.REGISTRY["queen5_5"]()
    seen = _walk(g, 17, [], cap=1 << 13, block=256,
                 flags=FLAG_CONFIGS[config])
    assert len(seen) > 3
    if config in ("bloom", "simplicial"):
        assert max(c for c, _, _ in seen) > 256


def test_levels_forced_overflow():
    g = ref_graph.gnp(18, 0.3, 4)
    seen = _walk(g, 6, [], cap=256, block=128)
    assert any(d > 0 for _, _, d in seen), "no level overflowed"


def test_levels_block_equal_to_small_block_and_narrow():
    g = ref_graph.gnp(16, 0.35, 8)
    _walk(g, 5, [0, 1], cap=512, block=32)
    _walk(g, 5, [0, 1], cap=512, block=128)


def test_multi_level_run_matches_from_root():
    g = ref_graph.gnp(17, 0.3, 5)
    adj, allowed = _inputs(g, [])
    n, w, cap = g.n, 1, 256
    root = (np.zeros((cap, w), dtype=np.uint32), 1, 0)
    for levels in (3, 100):
        want = _ref_step(adj, allowed, 6, n - 7, root, n=n, cap=cap,
                         block=128, levels=levels)
        got = _port_step(adj, allowed, 6, n - 7, root, n=n, cap=cap,
                         block=128, levels=levels)
        _assert_same(got, want)


@pytest.mark.parametrize("cap,k", [(1 << 12, 6), (128, 6)])
def test_host_engine_levels_with_adaptive_block(cap, k):
    import repro.core.frontier as rf
    g = ref_graph.gnp(17, 0.3, 6)
    n, w = g.n, 1
    adj, allowed = _inputs(g, [])
    ref_fr = rf.empty_frontier(cap, w)
    fr = frontier.empty_frontier(cap, w, "cpu")
    a_t, al_t = bitset.to_words(adj, "cpu"), bitset.to_words(allowed, "cpu")
    saw_drop = False
    for _ in range(n - k - 1):
        ref_fr, ref_stats = ref_solver.run_level(
            jnp.asarray(adj), ref_fr, k, jnp.asarray(allowed), n=n, cap=cap,
            block=2048, tracker=telemetry.NULL, **REF_KW)
        fr, stats = solver.run_level(a_t, fr, k, al_t, n=n, cap=cap,
                                     block=2048, schedule="doubling",
                                     tracker=telemetry.NULL)
        assert (stats.expanded, stats.generated, stats.dropped) == (
            ref_stats.expanded, ref_stats.generated, ref_stats.dropped)
        states, count, dropped = fr.to_numpy()
        np.testing.assert_array_equal(states, np.asarray(ref_fr.states))
        assert count == int(ref_fr.count)
        saw_drop |= stats.dropped > 0
        if count == 0:
            break
    assert saw_drop == (cap == 128)


def test_decide_both_engines_match_reference():
    g = ref_graph.gnp(15, 0.35, 2)
    pg = solver.Graph(g.n, g.adj.copy(), g.name)
    for engine_name in ("fused", "host"):
        for k in (3, 5):
            want = ref_solver.decide(g, k, [1], cap=256, block=64,
                                     engine=engine_name, **REF_KW)
            got = solver.decide(pg, k, [1], cap=256, block=64,
                                engine=engine_name, device="cpu")
            assert (got.feasible, got.inexact, got.expanded) == (
                want.feasible, want.inexact, want.expanded)


def test_geometry_validation_matches_reference():
    for cap, block, adaptive in [(256, 64, False), (96, 64, False),
                                 (256, 512, False), (96, 32, True),
                                 (100, 64, True)]:
        try:
            want = ref_engine.validate_geometry(cap, block,
                                                adaptive=adaptive)
        except ValueError:
            with pytest.raises(ValueError, match="must divide cap"):
                engine.validate_geometry(cap, block, adaptive=adaptive)
        else:
            assert engine.validate_geometry(cap, block,
                                            adaptive=adaptive) == want


def test_dispatch_handle_counts_one_sync_and_caches():
    g = ref_graph.gnp(10, 0.4, 1)
    tr = telemetry.Tracker()
    adj, allowed = _inputs(g, [])
    h = engine.fused_decide_launch(
        bitset.to_words(adj, "cpu"), bitset.to_words(allowed, "cpu"), 3, 6,
        n=g.n, cap=64, block=32, tracker=tr)
    assert h.ready()
    first = h.result()
    assert h.result() is first
    assert tr["dispatches"] == 1 and tr["host_syncs"] == 1
    assert isinstance(first[3].states, torch.Tensor)
