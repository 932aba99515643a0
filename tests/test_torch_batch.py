"""Port parity: the multi-lane engine (``repro_torch.core.batch``).

Lanes of the port and of the reference (``repro.core.batch``, whose lane
axis is ``jax.vmap``) get the same graphs, ks and padding; verdicts,
``expanded``, per-lane final frontiers (every row in order, ``count``,
``dropped``), levels, widths, bounds, ``per_k`` and orders must be equal,
bit for bit.  Cases cover the four engine configurations of
``tests/test_batch.py``, overflow, padding across a word boundary,
trivial lanes, lanes in the narrow and the wide chunk branch of one
dispatch, speculative ``solve(lanes=3)``, ``solve_many``, the lane forms
of the plain ops against their single-lane forms, and the capability
checks.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from repro.core import batch as ref_batch
from repro.core import bitset as ref_bitset
from repro.core import frontier as ref_frontier
from repro.core import graph as ref_graph
from repro.core import solver as ref_solver
from repro.core import telemetry as ref_telemetry
from repro_torch.core import (backend, batch, bitset, bloom, dedup, engine,
                              frontier, graph, solver, telemetry)
from repro_torch.kernels import bloom as bloom_kernel
from repro_torch.kernels import wavefront as wavefront_kernel

CONFIGS = [
    dict(mode="sort", use_mmw=False, use_simplicial=False),
    dict(mode="bloom", use_mmw=False, use_simplicial=False),
    dict(mode="sort", use_mmw=True, use_simplicial=False),
    dict(mode="sort", use_mmw=False, use_simplicial=True),
]
CONFIG_IDS = ["sort", "bloom", "sort+mmw", "sort+simplicial"]
DECIDE_KW = dict(cap=1 << 10, block=32, m_bits=1 << 12, k_hashes=4)
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


def _lanes(spec):
    """(reference lanes, port lanes) from [(graph, k, clique)]."""
    return ([ref_batch.Lane(g, k, tuple(c)) for g, k, c in spec],
            [batch.Lane(_port_graph(g), k, tuple(c)) for g, k, c in spec])


def _verdicts(results):
    return [(r.feasible, r.inexact, r.expanded) for r in results]


def _ref_lanes_decide(lanes, *, n_pad, cap, block, cfg, m_bits=1 << 12,
                      k_hashes=4):
    w = ref_bitset.n_words(n_pad)
    adj, allowed, ks, targets = ref_batch._pack_lanes(lanes, n_pad, w)
    fr, levels, expanded, dropped = ref_batch._lanes_decide(
        jnp.asarray(adj), jnp.asarray(allowed), jnp.asarray(ks),
        jnp.asarray(targets), ref_frontier.lane_frontiers(len(lanes), cap, w),
        n=n_pad, cap=cap, block=block, m_bits=m_bits, k_hashes=k_hashes,
        schedule="doubling", backend="jax", **cfg)
    return (np.asarray(fr.states), np.asarray(fr.count),
            np.asarray(fr.dropped), np.asarray(levels),
            np.asarray(expanded), np.asarray(dropped))


def _port_lanes_decide(lanes, *, n_pad, cap, block, cfg, m_bits=1 << 12,
                       k_hashes=4):
    w = bitset.n_words(n_pad)
    adj, allowed, ks, targets = batch._pack_lanes(lanes, n_pad, w)
    fr, levels, expanded, dropped = engine.decide_loop(
        bitset.to_words(adj, "cpu"), bitset.to_words(allowed, "cpu"),
        torch.from_numpy(ks), targets.tolist(),
        frontier.lane_frontiers(len(lanes), cap, w, "cpu"), n=n_pad,
        cap=cap, block=block, m_bits=m_bits, k_hashes=k_hashes,
        schedule="doubling", backend="torch", **cfg)
    states, count, drop = fr.to_numpy()
    return (states, count, drop, np.asarray(levels), np.asarray(expanded),
            dropped.numpy())


def _assert_same_lanes(spec, *, n_pad, cap, block, cfg):
    ref_l, port_l = _lanes(spec)
    want = _ref_lanes_decide(ref_l, n_pad=n_pad, cap=cap, block=block,
                             cfg=cfg)
    got = _port_lanes_decide(port_l, n_pad=n_pad, cap=cap, block=block,
                             cfg=cfg)
    names = ("states", "count", "dropped", "levels", "expanded",
             "dropped_total")
    for name, a, b in zip(names, got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    return got


# ------------------------------------------------------------ decide_lanes

@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_decide_lanes_matches_reference(cfg):
    """Verdicts, ``expanded`` and the lane counters against the
    reference's ``decide_lanes``; and each lane against the port's own
    single-lane ``decide``."""
    g = ref_graph.petersen()
    ref_l, port_l = _lanes([(g, k, ()) for k in range(2, 6)])
    ref_tr, port_tr = ref_telemetry.Tracker(), telemetry.Tracker()
    want = ref_batch.decide_lanes(ref_l, schedule="doubling", backend="jax",
                                  tracker=ref_tr, **DECIDE_KW, **cfg)
    got = batch.decide_lanes(port_l, device="cpu", tracker=port_tr,
                             **DECIDE_KW, **cfg)
    assert _verdicts(got) == _verdicts(want)
    keys = ("lanes_decided", "lane_expanded", "lane_overflows", "dispatches")
    ref_c = ref_tr.snapshot()["counters"]
    port_c = port_tr.snapshot()["counters"]
    assert {k: port_c.get(k, 0) for k in keys} == \
        {k: ref_c.get(k, 0) for k in keys}
    for lane, res in zip(port_l, got):
        one = solver.decide(lane.g, lane.k, [], device="cpu", **DECIDE_KW,
                            **cfg)
        assert (res.feasible, res.inexact, res.expanded) == \
            (one.feasible, one.inexact, one.expanded), lane.k


@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_lane_frontiers_match_reference_with_overflow(cfg):
    """Per-lane final frontiers of ``decide_loop`` against
    ``batch._lanes_decide``: lanes of different n and k (one infeasible,
    one feasible, one finishing early), a clique skip set, and a cap small
    enough that the lanes overflow."""
    gs = [ref_graph.gnp(12, 0.45, 3), ref_graph.myciel(3),
          ref_graph.gnp(9, 0.5, 1)]
    spec = [(gs[0], 4, ()), (gs[1], 4, (0, 1)), (gs[0], 6, ()),
            (gs[2], 2, ())]
    got = _assert_same_lanes(spec, n_pad=12, cap=64, block=32, cfg=cfg)
    assert got[5].any(), "no lane overflowed"


@pytest.mark.parametrize("mode", ["sort", "bloom"])
def test_cross_n_padding_across_a_word_boundary(mode):
    """n in {10, 23, 33} padded to 40 (W = 2 for every lane): frontiers
    and verdicts equal to the reference's, and the verdicts to each
    lane's unpadded single-lane run in sort mode."""
    gs = [ref_graph.petersen(), ref_graph.gnp(23, 0.3, 5),
          ref_graph.gnp(33, 0.2, 7)]
    spec = [(gs[0], 3, ()), (gs[1], 17, ()), (gs[2], 28, ()),
            (gs[2], 2, ())]
    cfg = dict(mode=mode, use_mmw=False, use_simplicial=False)
    _assert_same_lanes(spec, n_pad=40, cap=256, block=32, cfg=cfg)
    ref_l, port_l = _lanes(spec)
    kw = dict(cap=256, block=32, m_bits=1 << 12, k_hashes=4, **cfg)
    want = ref_batch.decide_lanes(ref_l, n_pad=40, lane_pad=8,
                                  schedule="doubling", backend="jax", **kw)
    got = batch.decide_lanes(port_l, n_pad=40, lane_pad=8, device="cpu",
                             **kw)
    assert _verdicts(got) == _verdicts(want)
    if mode == "sort":
        for lane, res in zip(port_l, got):
            one = solver.decide(lane.g, lane.k, [], device="cpu", **kw)
            assert (res.feasible, res.inexact, res.expanded) == \
                (one.feasible, one.inexact, one.expanded)


def test_trivial_target_lanes():
    """k + 1 >= n lanes are feasible with nothing expanded, beside a lane
    that runs, as ``solver.decide``'s early return."""
    g = ref_graph.petersen()
    spec = [(g, g.n - 1, ()), (g, 3, ()), (g, g.n, ()),
            (ref_graph.complete(4), 3, ())]
    ref_l, port_l = _lanes(spec)
    kw = dict(cap=256, block=32, mode="sort", use_mmw=False, m_bits=64,
              k_hashes=1)
    want = ref_batch.decide_lanes(ref_l, schedule="doubling", **kw)
    got = batch.decide_lanes(port_l, device="cpu", **kw)
    assert _verdicts(got) == _verdicts(want)
    assert _verdicts(got)[0] == _verdicts(got)[2] == (True, False, 0)
    assert batch.decide_lanes([], device="cpu", **kw) == []


@pytest.mark.parametrize("cap", [4096, 512], ids=["fits", "overflows"])
@pytest.mark.parametrize("mode", ["sort", "bloom"])
def test_narrow_and_wide_lanes_share_a_dispatch(mode, cap, monkeypatch):
    """block=256: petersen's frontiers stay within SMALL_BLOCK (the narrow
    branch) while myciel4's levels span several 256-row chunks (the wide
    branch and the cross-chunk dedup), in the same dispatch; frontiers,
    drops and (in Bloom mode) insert order as the reference's, and
    verdicts as each lane's single-lane run."""
    spec = [(ref_graph.myciel(4), 8, ()), (ref_graph.petersen(), 3, ()),
            (ref_graph.myciel(4), 9, ()), (ref_graph.petersen(), 4, ())]
    cfg = dict(mode=mode, use_mmw=False, use_simplicial=False)
    levels = []
    step = engine._level_step

    def spy(adj, allowed, k, fr, counts, live, **kw):
        levels.append([c for c, on in zip(counts, live) if on])
        return step(adj, allowed, k, fr, counts, live, **kw)

    monkeypatch.setattr(engine, "_level_step", spy)
    _assert_same_lanes(spec, n_pad=23, cap=cap, block=256, cfg=cfg)
    assert any(max(c) > 256 and min(c) <= engine.SMALL_BLOCK
               for c in levels), levels
    _, port_l = _lanes(spec)
    res = batch.decide_lanes(port_l, cap=cap, block=256, m_bits=1 << 12,
                             k_hashes=4, device="cpu", **cfg)
    for lane, r in zip(port_l, res):
        if lane.g.n != 23:
            continue        # petersen's own run has another n
        one = solver.decide(lane.g, lane.k, [], cap=cap, block=256,
                            m_bits=1 << 12, k_hashes=4, device="cpu", **cfg)
        assert (r.feasible, r.inexact, r.expanded) == \
            (one.feasible, one.inexact, one.expanded)


# ------------------------------------------------------------- solve lanes

GOLDEN = oracle.golden_cases()


def test_speculative_solve_matches_reference_and_one_lane():
    """``solve(g, lanes=3)`` on every non-slow golden instance (FAST
    geometry, where myciel4 and desargues overflow): equal to the
    reference's ``solve(g, lanes=3)`` and to the port's ``lanes=1``."""
    for name, make, tw in GOLDEN:
        g = make()
        want = ref_solver.solve(g, lanes=3, **FAST)
        tr = telemetry.Tracker()
        got = solver.solve(_port_graph(g), lanes=3, device="cpu",
                           tracker=tr, **FAST)
        one = solver.solve(_port_graph(g), device="cpu", **FAST)
        summary = (got.width, got.exact, got.lb, got.ub, got.expanded,
                   got.per_k)
        assert summary == (want.width, want.exact, want.lb, want.ub,
                           want.expanded, want.per_k), name
        assert summary == (one.width, one.exact, one.lb, one.ub,
                           one.expanded, one.per_k), name
        if got.expanded:
            c = tr.snapshot()["counters"]
            assert c["expanded"] == got.expanded
            assert c["lanes_decided"] >= c["rungs_decided"]


def test_speculative_solve_falls_back_to_one_lane():
    """``reconstruct=True`` and ``engine="host"`` decide one rung at a
    time, silently, as the reference does."""
    g = ref_graph.petersen()
    for kw in (dict(reconstruct=True), dict(engine="host")):
        tr = telemetry.Tracker()
        got = solver.solve(_port_graph(g), lanes=4, device="cpu",
                           tracker=tr, **FAST, **kw)
        want = ref_solver.solve(g, lanes=4, **FAST, **kw)
        assert (got.width, got.expanded, got.per_k, got.order) == \
            (want.width, want.expanded, want.per_k, want.order)
        assert "lanes_decided" not in tr.snapshot()["counters"]


# -------------------------------------------------------------- solve_many

def _edge_graphs():
    return [ref_graph.Graph(0, np.zeros((0, 0), dtype=bool), "empty"),
            ref_graph.Graph(1, np.zeros((1, 1), dtype=bool), "single")]


def _suite():
    return [ref_graph.petersen(), ref_graph.myciel(3), ref_graph.grid(3, 4),
            ref_graph.gnp(11, 0.4, 2)] + _edge_graphs()


def _result(r):
    return (r.width, r.exact, r.lb, r.ub, r.expanded, r.per_k, r.order)


@pytest.mark.parametrize("pre", [True, False], ids=["pre", "nopre"])
@pytest.mark.parametrize("speculate", [1, 2])
@pytest.mark.parametrize("cfg", [dict(mode="sort"),
                                 dict(mode="bloom", use_mmw=True)],
                         ids=["sort", "bloom+mmw"])
def test_solve_many_matches_reference(cfg, speculate, pre):
    gs = _suite()
    kw = dict(cap=1 << 10, block=32, m_bits=1 << 14, lanes=4,
              speculate=speculate, use_preprocess=pre, **cfg)
    want = ref_batch.solve_many(gs, schedule="doubling", **kw)
    got = batch.solve_many([_port_graph(g) for g in gs], device="cpu", **kw)
    assert [_result(r) for r in got] == [_result(r) for r in want]


def test_solve_many_reconstructs_orders_as_reference():
    gs = _suite()
    want = ref_batch.solve_many(gs, reconstruct=True, schedule="doubling",
                                **FAST)
    got = batch.solve_many([_port_graph(g) for g in gs], reconstruct=True,
                           device="cpu", **FAST)
    assert [_result(r) for r in got] == [_result(r) for r in want]
    for g, r in zip(gs, got):
        assert r.order is not None
        assert solver.order_width(_port_graph(g), r.order) <= r.width


def test_solve_many_matches_sequential_solve():
    gs = [ref_graph.petersen(), ref_graph.myciel(3), ref_graph.queen(4)]
    port = [_port_graph(g) for g in gs]
    got = batch.solve_many(port, device="cpu", **FAST)
    seq = [solver.solve(g, device="cpu", **FAST) for g in port]
    assert [_result(r) for r in got] == [_result(r) for r in seq]


def test_instance_state_anytime_and_improve_bounds():
    """``InstanceState`` mid-ladder: bounds, an anytime result, and an
    improved ub that closes the ladder; the same calls on the reference's
    ``InstanceState`` give the same values."""
    g = ref_graph.myciel(4)
    plan_kw = dict(use_clique=True, use_paths=True, start_k=None)
    ref_inst = ref_batch.InstanceState(g, ref_solver, use_preprocess=True,
                                       plan_kw=plan_kw)
    inst = batch.InstanceState(_port_graph(g), solver,
                               use_preprocess=True, plan_kw=plan_kw)
    assert inst.bounds() == ref_inst.bounds()
    k = inst.run.k
    res = batch.LaneResult(False, False, 7)
    assert inst.feed(k, res) == ref_inst.feed(
        k, ref_batch.LaneResult(False, False, 7))
    assert inst.bounds() == ref_inst.bounds()
    assert inst.partial() == ref_inst.partial()
    a, b = inst.anytime_result(), ref_inst.anytime_result()
    assert (a.width, a.exact, a.lb, a.ub, a.expanded, a.per_k) == \
        (b.width, b.exact, b.lb, b.ub, b.expanded, b.per_k)
    order = list(range(g.n))
    hint = dict(lb=inst.run.k + 1, ub=inst.run.k + 1, ub_order=order)
    assert inst.improve_bounds(**hint) == ref_inst.improve_bounds(**hint)
    assert inst.result is not None and ref_inst.result is not None
    assert (inst.result.width, inst.result.exact) == \
        (ref_inst.result.width, ref_inst.result.exact)


# ------------------------------------------------ lane forms of the ops

def _lane_inputs(n, b, lanes, seed):
    """Per-lane adj, states, ragged valid rows (lane 1 has none), k and
    allowed for seeded G(n, p) graphs."""
    rng = np.random.RandomState(seed)
    adj = np.stack([graph.gnp(n, 0.3 + 0.1 * i, seed + i).packed()
                    for i in range(lanes)])
    bits = rng.rand(lanes, b, n) < 0.4
    states = np.stack([bitset.np_pack([set(np.nonzero(r)[0]) for r in lb],
                                      n) for lb in bits])
    valid = np.arange(b)[None] < rng.randint(0, b + 1, size=(lanes, 1))
    if lanes > 1:
        valid[1] = False
    allowed = np.stack([bitset.np_allowed(n, [i % n]) for i in range(lanes)])
    k = rng.randint(1, n // 2 + 2, size=lanes).astype(np.int32)
    return (bitset.to_words(adj, "cpu"), bitset.to_words(states, "cpu"),
            torch.from_numpy(valid), torch.from_numpy(k),
            bitset.to_words(allowed, "cpu"))


@pytest.mark.parametrize("flags", [(False, False), (True, False),
                                   (False, True), (True, True)],
                         ids=["none", "mmw", "simplicial", "both"])
def test_lane_wavefront_matches_single_lane(flags):
    kw = dict(use_mmw=flags[0], use_simplicial=flags[1])
    for n, lanes in ((9, 1), (33, 3), (20, 8)):
        adj, states, valid, k, allowed = _lane_inputs(n, 13, lanes, n)
        got = wavefront_kernel.wavefront_expand(adj, states, valid, k,
                                                allowed, n=n, **kw)
        assert got[0].shape == (lanes, 13, n, adj.shape[-1])
        for i in range(lanes):
            want = wavefront_kernel.wavefront_ref(
                adj[i], states[i], valid[i], int(k[i]), allowed[i], n=n,
                **kw)
            assert torch.equal(got[0][i], want[0])
            assert torch.equal(got[1][i], want[1])
        assert not got[1][1].any() if lanes > 1 else True


def test_lane_bloom_ops_match_single_lane():
    """The packed row-order plain version and the ``torch`` op, each with
    a lane axis, against the same op lane by lane; 64-bit filters make
    rows collide."""
    rng = np.random.RandomState(0)
    lanes, b, m_bits = 3, 40, 64
    words = rng.randint(0, 2**32, size=(lanes, b, 2), dtype=np.uint64)
    states = bitset.to_words(words.astype(np.uint32), "cpu")
    valid = torch.from_numpy(rng.rand(lanes, b) < 0.8)
    valid[1] = False
    for _ in range(2):                       # the filters carry over
        packed = bloom_kernel.make_filter_words(m_bits, lanes=lanes)
        single = [bloom_kernel.make_filter_words(m_bits)
                  for _ in range(lanes)]
        got, _ = bloom_kernel.bloom_insert(packed, states, valid,
                                           m_bits=m_bits, k_hashes=3)
        for i in range(lanes):
            want, filt = bloom_kernel.bloom_insert_ref(
                single[i], states[i], valid[i], m_bits=m_bits, k_hashes=3)
            assert torch.equal(got[i], want)
            assert torch.equal(packed[i], filt)
        bytes_ = bloom.make_filter(m_bits, lanes=lanes)
        got, _ = bloom.query_and_insert(bytes_, states, valid, m_bits, 3)
        for i in range(lanes):
            want, filt = bloom.query_and_insert(bloom.make_filter(m_bits),
                                                states[i], valid[i],
                                                m_bits, 3)
            assert torch.equal(got[i], want)
            assert torch.equal(bytes_[i], filt)


def test_lane_sort_and_compact_match_single_lane():
    """Lane-segmented sort, first-occurrence mask and compaction at
    per-lane offsets (one lane overflowing) against each lane alone."""
    rng = np.random.RandomState(1)
    lanes, m, cap = 4, 50, 32
    words = rng.randint(0, 4, size=(lanes, m, 2)).astype(np.uint32)
    words[..., 0] |= np.uint32(1 << 31)          # unsigned order matters
    keys = bitset.to_words(words, "cpu")
    valid = torch.from_numpy(rng.rand(lanes, m) < 0.7)
    offset = torch.tensor([0, 5, 31, 12])
    sk, sv = dedup.sort_states(keys, valid)
    keep = dedup.unique_mask(sk, sv)
    out = engine.new_out(cap, 2, "cpu", lanes=lanes)
    buf, written, dropped = dedup.compact(sk, keep, cap, offset=offset,
                                          out=out)
    assert int(dropped[2]) > 0
    for i in range(lanes):
        s1, v1 = dedup.sort_states(keys[i], valid[i])
        k1 = dedup.unique_mask(s1, v1)
        assert torch.equal(sk[i], s1) and torch.equal(keep[i], k1)
        b1, w1, d1 = dedup.compact(s1, k1, cap, offset=int(offset[i]),
                                   out=engine.new_out(cap, 2, "cpu"))
        assert torch.equal(buf[i], b1)
        assert (int(written[i]), int(dropped[i])) == (int(w1), int(d1))
    full, cnt, drop = dedup.dedup_compact(keys, valid, cap)
    for i in range(lanes):
        f1, c1, d1 = dedup.dedup_compact(keys[i], valid[i], cap)
        assert torch.equal(full[i], f1) and int(cnt[i]) == int(c1)


def test_lane_frontier_round_trip():
    states = np.arange(3 * 8 * 2, dtype=np.uint32).reshape(3, 8, 2)
    states[0, 0, 0] = 0xFFFFFFFF
    fr = frontier.from_numpy(states, [3, 0, 8], [1, 0, 2], "cpu")
    got = fr.to_numpy()
    np.testing.assert_array_equal(got[0], states)
    assert got[1].tolist() == [3, 0, 8] and got[2].tolist() == [1, 0, 2]
    np.testing.assert_array_equal(frontier.lane_to_host(fr, 0), states[0, :3])
    assert frontier.lane_to_host(fr, 1).shape == (0, 2)
    root = frontier.lane_frontiers(2, 16, 1, "cpu")
    assert root.count.tolist() == [1, 1] and root.cap == 16
    assert frontier.frontier_bytes(16, 2, lanes=3) == 4 * 3 * 16 * 2


# ------------------------------------------------------------ capabilities

def test_lane_capability_checks():
    g = _port_graph(ref_graph.petersen())
    backend.validate("torch", lanes=2)
    backend.validate("cuda", lanes=8, mode="bloom", m_bits=1 << 10)
    assert backend.BATCHED_BACKENDS == ("torch", "cuda")
    with pytest.raises(backend.BackendCapabilityError, match="lanes must"):
        backend.validate("torch", lanes=0)
    with pytest.raises(backend.BackendCapabilityError, match="lanes must"):
        solver.solve(g, lanes=0, device="cpu", **FAST)
    with pytest.raises(backend.BackendCapabilityError, match="A10"):
        solver.solve(g, lanes=2, shards=2, device="cpu")
    with pytest.raises(backend.BackendCapabilityError, match="A9"):
        solver.solve(g, lanes=2, heuristics=1, device="cpu")
    with pytest.raises(backend.BackendCapabilityError, match="CUDA device"):
        solver.solve(g, lanes=2, backend="cuda", device="cpu")
    with pytest.raises(backend.BackendCapabilityError, match="CUDA device"):
        batch.decide_lanes([batch.Lane(g, 3)], backend="cuda", device="cpu",
                           mode="sort", use_mmw=False, m_bits=64,
                           k_hashes=1, **FAST)
    old = backend.BATCHED_BACKENDS
    backend.BATCHED_BACKENDS = ("torch",)
    try:
        with pytest.raises(backend.BackendCapabilityError, match="batched"):
            backend.validate("cuda", lanes=2)
    finally:
        backend.BATCHED_BACKENDS = old
