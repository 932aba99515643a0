"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels are CUDA C++ for ``sm_90a`` with no CPU mode.  The file imports
neither ``jax`` nor ``repro`` (inputs come from the port's own graph
generators and numpy), so it also runs where only the port is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` runs the same comparisons at the main path's shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bitset, components, graph
from repro_torch.kernels import bloom as bloom_kernel
from repro_torch.kernels import expand as expand_kernel
from repro_torch.kernels import mmw as mmw_kernel
from repro_torch.kernels import wavefront as wavefront_kernel

pytestmark = pytest.mark.cuda

FLAGS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for "
                    "sm_90a with no CPU mode (chip_smoke.py runs them)")
    return torch.device("cuda")


def _inputs(n, b, seed, dev):
    """adj, states (some with bit 31 set), valid (a quarter invalid), k,
    allowed (vertex 0 skipped) for a seeded G(n, 0.35)."""
    rng = np.random.RandomState(seed)
    g = graph.gnp(n, 0.35, seed)
    bits = rng.rand(b, n) < rng.uniform(0.05, 0.6, size=(b, 1))
    for top in (31, 63):
        if top < n:
            bits[::2, top] = True
    states = bitset.pack(torch.from_numpy(bits), n).to(dev)
    valid = torch.from_numpy(np.arange(b) % 4 != 0).to(dev)
    allowed = bitset.to_words(bitset.np_allowed(n, [0]), dev)
    return (bitset.to_words(g.packed(), dev), states, valid, n // 3,
            allowed)


@pytest.mark.parametrize("flags", FLAGS,
                         ids=["none", "mmw", "simplicial", "mmw+simplicial"])
def test_wavefront_kernel_matches_plain_version(dev, flags):
    kw = dict(use_mmw=flags[0], use_simplicial=flags[1])
    for n in (3, 17, 31, 33, 48, 64, 100):
        args = _inputs(n, 37, seed=n, dev=dev)
        gc, gf = wavefront_kernel.wavefront_expand(*args, n=n, **kw)
        wc, wf = wavefront_kernel.wavefront_ref(*args, n=n, **kw)
        assert torch.equal(gc, wc) and torch.equal(gf, wf), n


EDGE_N = (32, 33, 64, 65, 256)
EDGE_B = (1, 128, 2048)


@pytest.mark.parametrize("flags", FLAGS,
                         ids=["none", "mmw", "simplicial", "mmw+simplicial"])
def test_wavefront_kernel_edge_shapes(dev, flags):
    """Word and lane edges (n at and past 32 and 64, up to W = 8), one
    state, a SMALL_BLOCK chunk and a full chunk, and a chunk with no valid
    row."""
    kw = dict(use_mmw=flags[0], use_simplicial=flags[1])
    for n in EDGE_N:
        for b in EDGE_B:
            args = _inputs(n, b, seed=n + b, dev=dev)
            gc, gf = wavefront_kernel.wavefront_expand(*args, n=n, **kw)
            wc, wf = wavefront_kernel.wavefront_ref(*args, n=n, **kw)
            assert torch.equal(gc, wc) and torch.equal(gf, wf), (n, b)
        adj, states, valid, k, allowed = _inputs(n, 128, seed=n, dev=dev)
        args = (adj, states, torch.zeros_like(valid), k, allowed)
        gc, gf = wavefront_kernel.wavefront_expand(*args, n=n, **kw)
        wc, wf = wavefront_kernel.wavefront_ref(*args, n=n, **kw)
        assert torch.equal(gc, wc) and torch.equal(gf, wf) and not gf.any()


def test_expand_kernel_edge_shapes(dev):
    for n in EDGE_N:
        for b in EDGE_B:
            adj, states, _, _, _ = _inputs(n, b, seed=n + b, dev=dev)
            assert torch.equal(
                expand_kernel.expand_degrees(adj, states, n=n),
                expand_kernel.expand_degrees_ref(adj, states, n=n)), (n, b)


def test_mmw_kernel_matches_plain_version(dev):
    for n in (3, 17, 31, 33, 48, 64, 100):
        adj, states, valid, _, _ = _inputs(n, 37, seed=n, dev=dev)
        _, reach = components.eliminated_degrees(adj, states, n)
        reach = reach * valid[:, None, None]
        for k in (0, 2, 5, n):
            assert torch.equal(
                mmw_kernel.mmw_bounds(reach, states, k, n=n),
                mmw_kernel.mmw_bounds_ref(reach, states, k, n=n)), (n, k)


def test_expand_kernel_matches_plain_version(dev):
    for n in (3, 17, 31, 33, 48, 64, 100):
        adj, states, _, _, _ = _inputs(n, 37, seed=n, dev=dev)
        assert torch.equal(expand_kernel.expand_degrees(adj, states, n=n),
                           expand_kernel.expand_degrees_ref(adj, states,
                                                            n=n)), n


@pytest.mark.parametrize("m_bits,k", [(64, 3), (1 << 14, 17),
                                      (1 << 24, 17)])
def test_bloom_kernel_matches_plain_version(dev, m_bits, k):
    """Duplicates and, at 64 bits, rows sharing probe bits; the filter is
    carried from batch to batch."""
    rng = np.random.RandomState(m_bits + k)
    filt = bloom_kernel.make_filter_words(m_bits, device=dev)
    for b in (1, 300, 4096):
        states = rng.randint(0, 2**32, size=(b, 2), dtype=np.uint64).astype(
            np.uint32)
        states[1::3] = states[::3][:len(states[1::3])]       # duplicates
        s = bitset.to_words(states, dev)
        v = torch.from_numpy(rng.rand(b) < 0.9).to(dev)
        want = bloom_kernel.bloom_insert_ref(filt.clone(), s, v,
                                             m_bits=m_bits, k_hashes=k)
        got = bloom_kernel.bloom_insert(filt, s, v, m_bits=m_bits,
                                        k_hashes=k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _bloom_batches(rng, b):
    """Random rows with duplicates, a batch with no valid row, and one row
    repeated across a whole batch (valid everywhere)."""
    states = rng.randint(0, 2**32, size=(b, 2), dtype=np.uint64).astype(
        np.uint32)
    states[1::3] = states[::3][:len(states[1::3])]
    yield states, rng.rand(b) < 0.9
    yield states, np.zeros((b,), dtype=bool)
    yield np.repeat(states[:1], b, axis=0), np.ones((b,), dtype=bool)


@pytest.mark.parametrize("k", [1, 17, 33, 64])
def test_bloom_kernel_probe_counts(dev, k):
    """One probe, the default 17, and probe groups past one warp (33, 64),
    at 64 bits (every batch collides), 2^14 and 2^24 bits, the filter
    carried from batch to batch."""
    for m_bits in (64, 1 << 14, 1 << 24):
        rng = np.random.RandomState(m_bits + k)
        filt = bloom_kernel.make_filter_words(m_bits, device=dev)
        for b in (1, 300, 4096):
            for states, valid in _bloom_batches(rng, b):
                s = bitset.to_words(states, dev)
                v = torch.from_numpy(valid).to(dev)
                want = bloom_kernel.bloom_insert_ref(filt.clone(), s, v,
                                                     m_bits=m_bits,
                                                     k_hashes=k)
                got = bloom_kernel.bloom_insert(filt, s, v, m_bits=m_bits,
                                                k_hashes=k)
                assert torch.equal(got[0], want[0]), (m_bits, b)
                assert torch.equal(got[1], want[1]), (m_bits, b)


def test_wrappers_count_their_launches(dev):
    args = _inputs(20, 8, seed=1, dev=dev)
    before = wavefront_kernel.ops.LAUNCHES
    before_b = wavefront_kernel.ops.LAUNCHES_BY_B[8]
    wavefront_kernel.wavefront_expand(*args, n=20, use_mmw=True)
    assert wavefront_kernel.ops.LAUNCHES == before + 1
    assert wavefront_kernel.ops.LAUNCHES_BY_B[8] == before_b + 1
    before = bloom_kernel.ops.LAUNCHES
    filt = bloom_kernel.make_filter_words(1 << 10, device=dev)
    bloom_kernel.bloom_insert(filt, args[1], args[2], m_bits=1 << 10,
                              k_hashes=3)
    assert bloom_kernel.ops.LAUNCHES == before + 1


# ------------------------------------------------------------- lane forms

LANES = (1, 3, 8)


def _lane_inputs(n, b, lanes, seed, dev):
    """Per-lane graphs, states, ragged valid rows (lane 1 has none), an
    (L,) int32 k and allowed masks."""
    rng = np.random.RandomState(seed)
    per = [_inputs(n, b, seed + i, dev) for i in range(lanes)]
    valid = torch.from_numpy(
        np.arange(b)[None] < rng.randint(1, b + 1, size=(lanes, 1))).to(dev)
    if lanes > 1:
        valid[1] = False
    k = torch.tensor(rng.randint(n // 4, n // 2 + 1, size=lanes),
                     dtype=torch.int32, device=dev)
    return (torch.stack([p[0] for p in per]),
            torch.stack([p[1] for p in per]), valid, k,
            torch.stack([p[4] for p in per]))


@pytest.mark.parametrize("flags", FLAGS,
                         ids=["none", "mmw", "simplicial", "mmw+simplicial"])
def test_lane_wavefront_kernel_matches_plain_version(dev, flags):
    kw = dict(use_mmw=flags[0], use_simplicial=flags[1])
    for n in (17, 33, 49, 100):
        for lanes in LANES:
            for b in (7, 128):
                args = _lane_inputs(n, b, lanes, seed=n + b + lanes, dev=dev)
                gc, gf = wavefront_kernel.wavefront_expand(*args, n=n, **kw)
                wc, wf = wavefront_kernel.wavefront_ref(*args, n=n, **kw)
                assert torch.equal(gc, wc) and torch.equal(gf, wf), \
                    (n, lanes, b)
                if lanes > 1:
                    assert not gf[1].any()
    # a lane-strided view, as the engine's chunks of a frontier are
    adj, states, valid, k, allowed = _lane_inputs(49, 2048, 8, 1, dev)
    buf = torch.zeros((8, 3 * 2048, states.shape[-1]), dtype=torch.int32,
                      device=dev)
    buf[:, 2048:4096] = states
    view = buf[:, 2048:4096]
    got = wavefront_kernel.wavefront_expand(adj, view, valid, k, allowed,
                                            n=49, **kw)
    want = wavefront_kernel.wavefront_ref(adj, states, valid, k, allowed,
                                          n=49, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("m_bits,k", [(64, 3), (1 << 14, 17),
                                      (1 << 24, 17)])
def test_lane_bloom_kernel_matches_plain_version(dev, m_bits, k):
    """One filter per lane, carried from batch to batch, a lane with no
    valid row; at 64 bits rows share probe bits."""
    for lanes in LANES:
        rng = np.random.RandomState(m_bits + k + lanes)
        filt = bloom_kernel.make_filter_words(m_bits, device=dev,
                                              lanes=lanes)
        for b in (1, 300, 4096):
            states = rng.randint(0, 2**32, size=(lanes, b, 2),
                                 dtype=np.uint64).astype(np.uint32)
            states[:, 1::3] = states[:, ::3][:, :states[:, 1::3].shape[1]]
            s = bitset.to_words(states, dev)
            v = torch.from_numpy(rng.rand(lanes, b) < 0.9).to(dev)
            if lanes > 1:
                v[1] = False
            want = bloom_kernel.bloom_insert_ref(filt.clone(), s, v,
                                                 m_bits=m_bits, k_hashes=k)
            got = bloom_kernel.bloom_insert(filt, s, v, m_bits=m_bits,
                                            k_hashes=k)
            assert torch.equal(got[0], want[0]), (lanes, b)
            assert torch.equal(got[1], want[1]), (lanes, b)


def test_lane_dispatch_launches_once_per_chunk_of_all_lanes(dev,
                                                            monkeypatch):
    """A dispatch of L lanes launches the wavefront kernel max_l chunks_l
    times per level (each launch covering every live lane), not
    sum_l chunks_l, and the Bloom kernel as often in Bloom mode."""
    from repro_torch.core import batch, engine
    levels = []
    step = engine._level_step

    def spy(adj, allowed, k, fr, counts, live, **kw):
        levels.append([c for c, on in zip(counts, live) if on])
        return step(adj, allowed, k, fr, counts, live, **kw)

    monkeypatch.setattr(engine, "_level_step", spy)
    lanes = [batch.Lane(graph.myciel(4), 8), batch.Lane(graph.petersen(), 3),
             batch.Lane(graph.myciel(4), 9), batch.Lane(graph.petersen(), 4)]
    block = 256

    def chunks(c):
        own = engine.SMALL_BLOCK if c <= engine.SMALL_BLOCK else block
        return -(-c // own)

    for mode in ("sort", "bloom"):
        levels.clear()
        wf0, bl0 = (wavefront_kernel.ops.LAUNCHES,
                    bloom_kernel.ops.LAUNCHES)
        by_lanes = dict(wavefront_kernel.ops.LAUNCHES_BY_LANES)
        batch.decide_lanes(lanes, cap=4096, block=block, mode=mode,
                           use_mmw=False, m_bits=1 << 12, k_hashes=4,
                           device=dev)
        want = sum(max(chunks(c) for c in lv) for lv in levels)
        assert want < sum(chunks(c) for lv in levels for c in lv)
        assert wavefront_kernel.ops.LAUNCHES - wf0 == want
        assert bloom_kernel.ops.LAUNCHES - bl0 == \
            (want if mode == "bloom" else 0)
        grew = {n: v - by_lanes.get(n, 0) for n, v in
                wavefront_kernel.ops.LAUNCHES_BY_LANES.items()}
        assert sum(grew.values()) == want and grew.get(4, 0) > 0


@pytest.mark.parametrize("mode", ["sort", "bloom"])
def test_sharded_rung_launches_every_shard_at_once(dev, mode):
    """A sharded rung launches the wavefront kernel with all S shards as
    its lanes (one launch per chunk), and in Bloom mode the Bloom kernel
    once per level with S filters; its verdict, drops and expanded count
    are the CPU run's (sort mode: the plain ops give the same bits;
    Bloom: no probe collisions at these sizes)."""
    from repro_torch.core import shard
    g = graph.myciel(4)
    kw = dict(shards=3, cap=64, block=32, mode=mode, m_bits=1 << 20,
              k_hashes=4)
    for k in (8, 9, 10):
        wf = dict(wavefront_kernel.ops.LAUNCHES_BY_LANES)
        bl = dict(bloom_kernel.ops.LAUNCHES_BY_LANES)
        got = shard.decide_sharded(g, k, [0, 1], device=dev, **kw)
        want = shard.decide_sharded(g, k, [0, 1], device="cpu", **kw)
        assert (got.feasible, got.inexact, got.expanded) == \
            (want.feasible, want.inexact, want.expanded), k
        grew = {n: v - wf.get(n, 0) for n, v in
                wavefront_kernel.ops.LAUNCHES_BY_LANES.items()
                if v != wf.get(n, 0)}
        assert set(grew) == {3}, grew
        grew = {n: v - bl.get(n, 0) for n, v in
                bloom_kernel.ops.LAUNCHES_BY_LANES.items()
                if v != bl.get(n, 0)}
        assert set(grew) == ({3} if mode == "bloom" else set()), grew


def test_min_degree_sweep_on_the_card_matches_the_cpu(dev):
    from repro_torch.core import bounds_engine
    gs = [graph.petersen(), graph.myciel(4), graph.queen(6),
          graph.gnp(70, 0.1, 3)]
    seeds = [1, 2, 3, 2 ** 31 + 4]
    got = bounds_engine.ub_orders_async(gs, seeds, device=dev).result()
    want = bounds_engine.ub_orders_async(gs, seeds, device="cpu").result()
    assert got == want


@pytest.mark.parametrize("mode", ["sort", "bloom"])
def test_scheduler_serves_two_requests_on_the_card(dev, mode):
    """``TwScheduler(device="cuda")`` serves two requests through the lane
    forms of the kernels (one wavefront launch for both lanes while both
    run) with the results the same scheduler gives on the CPU, events
    included (their clocked ``timings`` dropped)."""
    from repro_torch.serve.twscheduler import TwScheduler

    def serve(device):
        events = []
        # a 2^24-bit filter stays nearly empty here, so the row-order
        # kernel and the batch-queried plain op keep the same bits
        s = TwScheduler(lanes=2, block=32, cap=1 << 12, mode=mode,
                        device=device)
        rids = [s.submit(g, on_event=events.append)
                for g in (graph.petersen(), graph.myciel(4))]
        s.run()
        for ev in events:
            if "metrics" in ev and ev["metrics"]:
                ev["metrics"].pop("timings", None)
                ev["metrics"].pop("scope", None)
        return [(r.width, r.exact, r.lb, r.ub, r.expanded, r.per_k)
                for r in (s.done[rid] for rid in rids)], events, s

    lanes = dict(wavefront_kernel.ops.LAUNCHES_BY_LANES)
    got, got_events, s = serve(dev)
    assert s.decide_kw["backend"] == "cuda"
    grew = {n: v - lanes.get(n, 0) for n, v in
            wavefront_kernel.ops.LAUNCHES_BY_LANES.items()
            if v != lanes.get(n, 0)}
    assert grew.get(2, 0) > 0, grew
    want, want_events, _ = serve("cpu")
    assert got == want
    assert got_events == want_events
    assert [r[0] for r in got] == [4, 10]
