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

from repro_torch.core import bitset, bounds, components, graph, telemetry
from repro_torch.kernels import bloom as bloom_kernel
from repro_torch.kernels import expand as expand_kernel
from repro_torch.kernels import mmw as mmw_kernel
from repro_torch.kernels import paths as paths_kernel
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


# the bucket geometry's edges (ops.scratch_plan): a 64-bit filter (one
# position a bucket, most buckets past the 32 claims a warp settles in
# registers), a size that is not a power of two, 2^12 (the most buckets
# of one position) and one word past it (the first size whose buckets
# hold 2 positions, the last of them partly empty), 2^13 and the sizes
# one word past a power of two (buckets of 2, 4 and 8 positions), the
# default (buckets of 4096 positions, four resolve windows each) and
# buckets of 16 windows (m_bits > 2^25)
REDESIGN_M_BITS = [64, 3200, 1 << 12, (1 << 12) + 32, 1 << 13,
                   (1 << 13) + 32, (1 << 14) + 32, 1 << 24, (1 << 25) + 32]


def _redesign_batches(rng, lanes, b):
    """(states (L, B, 2), valid (L, B)): valid rows interleaved with
    invalid ones at a different stride in each lane (lane 1 has none),
    duplicates; then one row repeated across every lane's whole batch."""
    states = rng.randint(0, 2**32, size=(lanes, b, 2),
                         dtype=np.uint64).astype(np.uint32)
    states[:, 1::3] = states[:, ::3][:, :states[:, 1::3].shape[1]]
    stride = np.arange(lanes)[:, None] + 2
    valid = (np.arange(b)[None] % stride == 0) | (rng.rand(lanes, b) < 0.1)
    if lanes > 1:
        valid[1] = False
    yield states, valid
    yield np.broadcast_to(states[:1, :1], states.shape).copy(), \
        np.ones((lanes, b), dtype=bool)


@pytest.mark.parametrize("k", [1, 17, 33, 64])
@pytest.mark.parametrize("m_bits", REDESIGN_M_BITS)
def test_bloom_kernel_bucket_edges(dev, m_bits, k):
    """Bit for bit against bloom_insert_ref in was_new and every filter
    word: L in (1, 3, 8), an empty and a half-full filter carried from
    batch to batch, interleaved valid rows, one repeated row, and a batch
    of 2048 * 49 rows per lane."""
    rng = np.random.RandomState(m_bits % 1009 + k)
    for lanes in LANES:
        half = rng.randint(0, 2**32, size=(lanes, m_bits // 32),
                           dtype=np.uint64).astype(np.uint32)
        for filt in (bloom_kernel.make_filter_words(m_bits, device=dev,
                                                    lanes=lanes),
                     bitset.to_words(half, dev)):
            batches = list(_redesign_batches(rng, lanes, 300))
            if lanes == 8:
                batches += list(_redesign_batches(rng, lanes, 2048 * 49))[:1]
            for states, valid in batches:
                s = bitset.to_words(states, dev)
                v = torch.from_numpy(valid).to(dev)
                want = bloom_kernel.bloom_insert_ref(filt.clone(), s, v,
                                                     m_bits=m_bits,
                                                     k_hashes=k)
                got = bloom_kernel.bloom_insert(filt, s, v, m_bits=m_bits,
                                                k_hashes=k)
                assert torch.equal(got[0], want[0]), (lanes, s.shape)
                assert torch.equal(got[1], want[1]), (lanes, s.shape)
                if lanes > 1 and not valid[1].any():
                    assert not got[0][1].any()


def test_bloom_kernel_records_in_a_cuda_graph(dev):
    """One call captured in a CUDA graph (the default capture mode fails on
    any host read) and replayed onto a restored filter, one lane and 8."""
    rng = np.random.RandomState(5)
    for lanes in (None, 8):
        lead = () if lanes is None else (lanes,)
        start = bloom_kernel.make_filter_words(1 << 24, device=dev,
                                               lanes=lanes)
        s = bitset.to_words(rng.randint(
            0, 2**32, size=lead + (4096, 2), dtype=np.uint64).astype(
                np.uint32), dev)
        v = torch.from_numpy(rng.rand(*lead, 4096) < 0.5).to(dev)
        want = bloom_kernel.bloom_insert_ref(start.clone(), s, v,
                                             m_bits=1 << 24, k_hashes=17)
        filt = start.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            bloom_kernel.bloom_insert(filt, s, v, m_bits=1 << 24,
                                      k_hashes=17)
        torch.cuda.current_stream().wait_stream(side)
        graph_ = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph_):
            was_new, _ = bloom_kernel.bloom_insert(filt, s, v,
                                                   m_bits=1 << 24,
                                                   k_hashes=17)
        filt.copy_(start)
        graph_.replay()
        torch.cuda.synchronize()
        assert torch.equal(was_new, want[0]) and torch.equal(filt, want[1])


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
    included (their clocked ``timings`` dropped, and the paths kernel's
    block count, which only the card has: one block each)."""
    from repro_torch.serve.twscheduler import TwScheduler

    def serve(device):
        events, kernel_blocks = [], []
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
                kernel_blocks.append(ev["metrics"]["counters"].pop(
                    "paths_kernel_blocks", 0))
        return [(r.width, r.exact, r.lb, r.ub, r.expanded, r.per_k)
                for r in (s.done[rid] for rid in rids)], events, s, \
            kernel_blocks

    lanes = dict(wavefront_kernel.ops.LAUNCHES_BY_LANES)
    got, got_events, s, got_blocks = serve(dev)
    assert s.decide_kw["backend"] == "cuda"
    grew = {n: v - lanes.get(n, 0) for n, v in
            wavefront_kernel.ops.LAUNCHES_BY_LANES.items()
            if v != lanes.get(n, 0)}
    assert grew.get(2, 0) > 0, grew
    want, want_events, _, want_blocks = serve("cpu")
    assert got == want
    assert got_events == want_events
    assert got_blocks == [1, 1] and want_blocks == [0, 0]
    assert [r[0] for r in got] == [4, 10]


def test_distributed_ranks_share_the_card(dev):
    """Two ranks on the one card (gloo, CUDA tensors in the collectives)
    give the CPU ranks' results, and the wavefront kernel launches in
    both."""
    import torch_dist_twins as twins
    from repro_torch.core import distributed
    kw = dict(cap_local=1 << 12, block=1 << 8)
    names = ["petersen", "queen5_5"]
    got = distributed.launch(twins.solve_rows_launched, 2, names,
                             device="cuda", deadline_s=300, **kw)
    want = twins.port(twins.solve_rows_launched, 2, names, **kw)
    assert [rows for rows, _ in got] == [rows for rows, _ in want]
    assert all(n > 0 for _, n in got), got
    assert all(n == 0 for _, n in want), want


# ------------------------------------- the wavefront kernel's tiled grid

TILE_B = (1, 7, 31, 32, 33, 127, 128, 129, 2047, 2048)
TILE_N = (17, 32, 33, 49, 64, 65, 256)
FLAG_IDS = ["none", "mmw", "simplicial", "mmw+simplicial"]


def replay_contraction(reach, s_bits, k, n, stop_at_k=False):
    """The MMW contraction (``repro_torch.core.mmw.mmw_bound``, the loop of
    ``rt::mmw_warp``) replayed step by step in numpy on bool matrices.
    With ``stop_at_k`` it also stops once nact - 1 <= k, as the wavefront
    kernel's MMW rule does.  Returns the final lb and (nact, lb) at the
    start of every step."""
    big = 1 << 20
    eye = np.eye(n, dtype=bool)
    active = ~s_bits
    a = reach & active[None, :] & ~eye & active[:, None]
    lb, nact, steps = 0, int(active.sum()), []
    while nact > 1 and lb <= k and not (stop_at_k and nact - 1 <= k):
        steps.append((nact, lb))
        d = np.where(active, a.sum(axis=1), big)
        v = int(np.argmin(d))
        second = np.where(np.arange(n) == v, big, d).min()
        lb = max(lb, int(min(second, big - 1)))
        u = int(np.argmin(np.where(a[v], d, big))) if d[v] > 0 else v
        merged = (a[v] | a[u]) & active
        merged[[u, v]] = False
        a[:, u] = False
        a[:, v] = merged
        a[v] = merged
        a[u] = False
        active[u] = False
        nact -= 1
    return lb, steps


def _tile_inputs(n, b, lanes, seed, dev):
    """Per-lane graphs (densities 0.2, 0.5, 0.9 in turn) and states of
    |S| about n/2, the same size within a lane, so that lane l's k, which
    cycles through 0, n-|S|-2, n-|S|-1, n-|S| and n, puts nact at k + 2
    and k + 1; lane 1 has no valid row, the others every third row
    invalid."""
    rng = np.random.RandomState(seed)
    adj, states, ks = [], [], []
    for lane in range(lanes):
        adj.append(graph.gnp(n, (0.2, 0.5, 0.9)[lane % 3],
                             seed + lane).packed())
        size = min(n - 1, max(0, n // 2 + lane % 3 - 1))
        bits = np.zeros((b, n), dtype=bool)
        for row in bits:
            row[rng.choice(n, size, replace=False)] = True
        states.append(bitset.np_pack([set(np.flatnonzero(r)) for r in bits],
                                     n))
        ks.append(max(0, (0, n - size - 2, n - size - 1, n - size,
                          n)[lane % 5]))
    valid = np.arange(b)[None].repeat(lanes, 0) % 3 != 0
    if lanes > 1:
        valid[1] = False
    allowed = np.stack([bitset.np_allowed(n, [lane % n])
                        for lane in range(lanes)])
    return (bitset.to_words(np.stack(adj), dev),
            bitset.to_words(np.stack(states), dev),
            torch.from_numpy(valid).to(dev),
            torch.tensor(ks, dtype=torch.int32, device=dev),
            bitset.to_words(allowed, dev))


def _same_as_plain(args, n, kw, label):
    gc, gf = wavefront_kernel.wavefront_expand(*args, n=n, **kw)
    wc, wf = wavefront_kernel.wavefront_ref(*args, n=n, **kw)
    assert torch.equal(gc, wc) and torch.equal(gf, wf), label
    return gf


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_tiled_wavefront_kernel_shapes(dev, flags):
    """Bit for bit against wavefront_ref at every chunk width B around a
    warp and a tile, every word edge of n up to W = 8, one lane and
    three, per-lane k at nact = k + 1 and k + 2, a lane with no valid
    row and interleaved invalid rows."""
    kw = dict(use_mmw=flags[0], use_simplicial=flags[1])
    for n in TILE_N:
        for b in TILE_B:
            for lanes in (1, 3):
                args = _tile_inputs(n, b, lanes, seed=n * b + lanes, dev=dev)
                if lanes == 1:
                    args = (args[0][0], args[1][0], args[2][0],
                            int(args[3][0]), args[4][0])
                gf = _same_as_plain(args, n, kw, (n, b, lanes))
                if lanes > 1:
                    assert not gf[1].any()


def _walks(w, flags, lanes, b):
    """Whether a launch of `lanes` x `b` states has more tiles than the
    grid has blocks: the launch's own geometry from the card's
    occupancy."""
    occ = wavefront_kernel.ops.occupancy(w, *flags)
    slots = occ["sms"] * occ["blocks_per_sm"]
    warps = occ["threads"] // 32
    spw = min(4, max(1, -(-lanes * b // (slots * warps))))
    return lanes * -(-b // (warps * spw)) > slots


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_tiled_wavefront_kernel_walks_tiles_across_lanes(dev, flags):
    """More tiles than the grid has blocks, so that every block walks
    several tiles and changes lane on the way: 8 and 33 lanes of 2048
    states (33 lanes also as a lane-strided view, as the engine's chunks
    are), and 8 lanes at n = 256, where one block fills an SM."""
    kw = dict(use_mmw=flags[0], use_simplicial=flags[1])
    for n, lanes in ((17, 33), (49, 8), (49, 33), (256, 8)):
        args = _tile_inputs(n, 2048, lanes, seed=n + lanes, dev=dev)
        if (n, lanes) != (49, 8):           # the lane paths' timing shape
            assert _walks(args[1].shape[-1], flags, lanes, 2048), (n, lanes)
        _same_as_plain(args, n, kw, (n, lanes))
    adj, states, valid, k, allowed = _tile_inputs(49, 2048, 33, 3, dev)
    assert _walks(2, flags, 33, 2048)
    buf = torch.zeros((33, 3 * 2048, 2), dtype=torch.int32, device=dev)
    buf[:, 2048:4096] = states
    got = wavefront_kernel.wavefront_expand(adj, buf[:, 2048:4096], valid,
                                            k, allowed, n=49, **kw)
    want = wavefront_kernel.wavefront_ref(adj, states, valid, k, allowed,
                                          n=49, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _solver_level(dev, name="queen7_7", k=30, block=2048):
    """The first ``block`` states of the largest level of ``name`` at k,
    as the engine expands them, with the block's adjacency and allowed
    mask."""
    from repro_torch.core import batch, preprocess, solver
    g = preprocess.preprocess(graph.REGISTRY[name]()).blocks[0].g
    plan = solver.plan_block(g, use_clique=True, use_paths=True,
                             start_k=None)
    gk = plan.graph_at(k)
    res = solver.decide(gk, k, plan.clique,
                        cap=batch.plan_capacity(g.n, block=block),
                        block=block, keep_levels=True, engine="host",
                        device=dev)
    level = max(res.levels, key=len)[:block]
    return (g.n, gk.packed(), np.asarray(level, dtype=np.uint32),
            bitset.np_allowed(g.n, plan.clique))


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_tiled_wavefront_kernel_on_solver_states(dev, flags):
    """The solver's own shape: queen7_7's largest level at k = 30 (|S| of
    4-5, a few components), on 8 lanes with k = 23..30 as the lane paths
    time it, and on one lane."""
    kw = dict(use_mmw=flags[0], use_simplicial=flags[1])
    n, adj, level, allowed = _solver_level(dev)
    lanes = 8
    states = bitset.to_words(np.broadcast_to(
        level, (lanes,) + level.shape).copy(), dev)
    valid = torch.ones((lanes, len(level)), dtype=torch.bool, device=dev)
    args = (bitset.to_words(np.broadcast_to(adj, (lanes,) + adj.shape)
                            .copy(), dev), states, valid,
            torch.arange(23, 31, dtype=torch.int32, device=dev),
            bitset.to_words(np.broadcast_to(allowed, (lanes,)
                                            + allowed.shape).copy(), dev))
    _same_as_plain(args, n, kw, "lanes")
    _same_as_plain((args[0][0], states[0], valid[0], 30, args[4][0]), n, kw,
                   "one lane")


def test_wavefront_kernel_records_in_a_cuda_graph(dev):
    """One call captured in a CUDA graph (the default capture mode fails on
    any host read) and replayed on new states and a new per-lane k, one
    lane and 8, under every flag set."""
    for use_mmw, use_simp in FLAGS:
        kw = dict(use_mmw=use_mmw, use_simplicial=use_simp)
        for lanes in (1, 8):
            first = _tile_inputs(49, 2048, lanes, seed=11, dev=dev)
            second = _tile_inputs(49, 2048, lanes, seed=12, dev=dev)
            if lanes == 1:
                first = (first[0][0], first[1][0], first[2][0], 20,
                         first[4][0])
                second = (first[0], second[1][0], second[2][0], 20,
                          first[4])
            args = [x.clone() if isinstance(x, torch.Tensor) else x
                    for x in first]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                wavefront_kernel.wavefront_expand(*args, n=49, **kw)
            torch.cuda.current_stream().wait_stream(side)
            graph_ = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph_):
                children, feasible = wavefront_kernel.wavefront_expand(
                    *args, n=49, **kw)
            for i, x in enumerate(second):
                if isinstance(x, torch.Tensor):
                    args[i].copy_(x)
            graph_.replay()
            torch.cuda.synchronize()
            want = wavefront_kernel.wavefront_ref(*second, n=49, **kw)
            assert torch.equal(children, want[0]), (kw, lanes)
            assert torch.equal(feasible, want[1]), (kw, lanes)


def test_mmw_kernel_unchanged_on_the_tile_states(dev):
    """B4 keeps the whole contraction and the reference's lb values: on
    the tiled tests' states, at k = 0, n - |S| - 2 .. n - |S| and n."""
    for n in (17, 33, 49, 65):
        adj, states, valid, ks, _ = _tile_inputs(n, 129, 5, seed=n, dev=dev)
        for lane in range(5):
            _, reach = components.eliminated_degrees(adj[lane],
                                                     states[lane], n)
            for k in ks.tolist():
                assert torch.equal(
                    mmw_kernel.mmw_bounds(reach, states[lane], k, n=n),
                    mmw_kernel.mmw_bounds_ref(reach, states[lane], k, n=n)), \
                    (n, lane, k)


def test_mmw_rule_where_lb_crosses_k_on_the_last_step(dev):
    """States with a feasible candidate whose full contraction lifts lb
    past k on its step with nact = k + 2, the last one the kernel's
    stopped loop runs (found by replaying the contraction in numpy): the
    kernel prunes them as the plain version does."""
    rng = np.random.RandomState(7)
    for n in (33, 49):
        g = graph.gnp(n, 0.3, n)
        adj = bitset.to_words(g.packed(), dev)
        allowed = bitset.to_words(bitset.np_full(n), dev)
        bits = rng.rand(256, n) < rng.uniform(0.05, 0.3, size=(256, 1))
        states = bitset.to_words(bitset.np_pack(
            [set(np.flatnonzero(r)) for r in bits], n), dev)
        deg, reach = components.eliminated_degrees(adj, states, n)
        reach = bitset.unpack(reach, n).cpu().numpy()
        deg = deg.cpu().numpy()
        by_k = {}
        for row in range(len(bits)):
            out = ~bits[row]
            # from the least k with a feasible candidate to nact - 3
            for k in range(int(deg[row][out].min()), int(out.sum()) - 2):
                lb, steps = replay_contraction(reach[row], bits[row].copy(),
                                               k, n, stop_at_k=True)
                if steps and steps[-1][0] == k + 2 and steps[-1][1] <= k < lb:
                    by_k.setdefault(k, []).append(row)
        assert by_k, n
        for k, rows in by_k.items():
            idx = torch.tensor(rows, device=dev)
            args = (adj, states[idx], torch.ones(len(rows), dtype=torch.bool,
                                                 device=dev), k, allowed)
            gf = _same_as_plain(args, n, dict(use_mmw=True), (n, k))
            assert not gf.any(), (n, k)


# ---------------------------------------------------------------- paths

PATHS_TABLE1 = ["myciel3", "myciel4", "queen5_5", "queen6_6", "petersen",
                "desargues", "mcgee", "queen7_7", "dyck", "grid6x6"]
# word edges up to W = 8
PATHS_EDGE_N = (31, 32, 33, 63, 64, 65, 95, 96, 97, 127, 128, 129, 159,
                160, 161, 191, 192, 193, 223, 224, 225, 255, 256)
# the host function takes seconds a graph past this n
PATHS_HOST_N = 40


def _paths_on_card(g, cap, dev):
    adj = bitset.to_words(g.packed(), dev)
    return paths_kernel.paths_matrix(adj, cap, n=g.n).cpu().numpy()


def _deep_cell_graph():
    """queen7_7 as the deep benchmark cell relabels it (pool seed 49,
    position 0)."""
    g = graph.REGISTRY["queen7_7"]()
    return g.relabel(np.random.default_rng([49, 0]).permutation(g.n))


def _paths_random_cases(count=200, seed=27):
    """(n, p, seed, cap): small graphs at any density and cap, graphs at
    the word edges sparse at any cap, and larger dense ones at small caps
    (what the plain version can check in seconds)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(count):
        kind = i % 4
        if kind < 2:
            n = int(rng.randint(2, PATHS_HOST_N + 1))
            p = rng.uniform(0.05, 0.95)
            cap = int(rng.choice([0, 1, 2, 4, 8, n, 64]))
        elif kind == 2:
            n = int(rng.choice(PATHS_EDGE_N))
            p = rng.uniform(0.01, 0.08)
            cap = int(rng.choice([0, 2, 8, 64, 300]))
        else:
            n = int(rng.randint(PATHS_HOST_N + 1, 257))
            p = rng.uniform(0.1, 0.9)
            cap = int(rng.choice([0, 1, 2, 3]))
        out.append((n, round(float(p), 3), seed * 1000 + i, cap))
    return out


def test_paths_kernel_matches_host_function_on_table1(dev):
    for name in PATHS_TABLE1:
        g = graph.REGISTRY[name]()
        for cap in (0, 2, bounds.upper_bound(g)[0]):
            np.testing.assert_array_equal(
                _paths_on_card(g, cap, dev),
                bounds.disjoint_paths_matrix(g, cap=cap), err_msg=name)


def test_paths_kernel_on_the_deep_cells_relabelling(dev):
    g = _deep_cell_graph()
    want = bounds.disjoint_paths_matrix(g, cap=37)
    np.testing.assert_array_equal(_paths_on_card(g, 37, dev), want)
    got = paths_kernel.ops.disjoint_paths_matrix(g.packed(), 37, device=dev)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("part", range(4))
def test_paths_kernel_on_random_graphs(dev, part):
    """200 seeded graphs up to n = 256 (W = 8), 50 a part: against the
    host function up to n = 40, past it against the plain version run on
    the card (itself held to the host function in test_torch_paths.py)."""
    for n, p, seed, cap in _paths_random_cases()[part::4]:
        g = graph.gnp(n, p, seed)
        got = _paths_on_card(g, cap, dev)
        if n <= PATHS_HOST_N:
            want = bounds.disjoint_paths_matrix(g, cap=cap)
        else:
            want = paths_kernel.paths_matrix_ref(
                bitset.to_words(g.packed(), dev), cap, n=n).cpu().numpy()
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"n={n} p={p} cap={cap}")
        np.testing.assert_array_equal(got, got.T)
        assert not np.diagonal(got).any()


def test_paths_kernel_counts_one_launch_and_one_block_per_call(dev):
    from repro_torch.core import solver
    g = graph.REGISTRY["queen6_6"]()
    adj = bitset.to_words(g.packed(), dev)
    before = paths_kernel.ops.LAUNCHES
    paths_kernel.paths_matrix(adj, 26, n=g.n)
    assert paths_kernel.ops.LAUNCHES == before + 1
    tr = telemetry.Tracker()
    plan = solver.plan_block(g, use_clique=True, use_paths=True,
                             start_k=None, tracker=tr, device=dev)
    assert paths_kernel.ops.LAUNCHES == before + 2
    assert tr.value("paths_kernel_blocks") == 1
    timings = tr.snapshot()["timings"]
    assert timings["paths_s"]["calls"] == timings["read_s"]["calls"] == 1
    np.testing.assert_array_equal(
        plan.paths, bounds.disjoint_paths_matrix(g, cap=plan.ub))
    host = solver.plan_block(g, use_clique=True, use_paths=True,
                             start_k=None, tracker=telemetry.Tracker())
    assert (plan.clique, plan.lb, plan.ub, plan.ub_order, plan.k0) == (
        host.clique, host.lb, host.ub, host.ub_order, host.k0)
    tr = telemetry.Tracker()
    res = solver.solve(g, device=dev, tracker=tr)
    assert res.width == 25 and res.exact
    assert tr.value("paths_kernel_blocks") == 1
    assert paths_kernel.ops.LAUNCHES == before + 3


def test_paths_kernel_does_not_wait_for_the_solvers_stream(dev):
    """With long work queued on the current stream, the planning form
    returns the right matrix before that work ends: its upload, launch and
    read run on the wrapper's own stream."""
    g = graph.REGISTRY["queen6_6"]()
    want = bounds.disjoint_paths_matrix(g, cap=26)
    paths_kernel.ops.disjoint_paths_matrix(g.packed(), 26, device=dev)
    torch.cuda.synchronize()
    torch.cuda._sleep(4_000_000_000)          # about 2 s of one block
    queued = torch.cuda.Event()
    queued.record()
    got = paths_kernel.ops.disjoint_paths_matrix(g.packed(), 26, device=dev)
    assert not queued.query()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, want)
