"""Port parity: the sharded engine (``repro_torch.core.shard``).

The port's shards and the reference's (``repro.core.shard``, whose shards
are ``jax.vmap`` lanes) get the same rows, counts and graphs; routing,
donation, repacking, sharded rungs and the CLI's result lines must be
equal bit for bit.  Whole sharded solves are in
``tests/test_torch_shard_solve.py``.  The port's ``torch`` Bloom shards
are held against the reference's ``jax`` backend (both query a batch
before inserting it).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from repro.core import bloom as ref_bloom
from repro.core import graph as ref_graph
from repro.core import shard as ref_shard
from repro.core import solver as ref_solver
from repro.core import telemetry as ref_telemetry
from repro_torch.core import (backend, bitset, bloom, frontier, graph,
                              shard, solver, telemetry)

BLOCK = 1 << 6
CONFIGS = [
    dict(mode="sort", use_mmw=False, use_simplicial=False),
    dict(mode="bloom", use_mmw=False, use_simplicial=False),
    dict(mode="sort", use_mmw=True, use_simplicial=False),
    dict(mode="sort", use_mmw=False, use_simplicial=True),
]
CONFIG_IDS = ["sort", "bloom", "sort+mmw", "sort+simplicial"]
SHARD_KEYS = ("shard_donations", "shard_donated_rows", "shard_idle_steps",
              "shard_peak_occupancy", "dispatches")


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


def _counters(tr, keys=SHARD_KEYS):
    c = tr.snapshot()["counters"]
    g = tr.snapshot().get("gauges", {})
    return {k: c.get(k, g.get(k, 0)) for k in keys}


def _rows(seed, m, w, high=False):
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, 2 ** 32, size=(m, w), dtype=np.uint64).astype(
        np.uint32)
    if high:
        rows[::2, 0] |= np.uint32(1 << 31)      # words >= 2^31
    rows[5::7] = rows[3::7][:len(rows[5::7])]   # duplicate rows
    valid = rng.rand(m) < 0.8
    return rows, valid


# ------------------------------------------------------------ unit helpers

@pytest.mark.parametrize("m,w,s,cap_recv", [
    (64, 2, 4, 64), (200, 1, 3, 128), (300, 3, 2, 40), (97, 2, 4, 8)],
    ids=["fits", "one-word", "overflows", "overflows-4"])
def test_route_states_matches_reference(m, w, s, cap_recv):
    """Owner buckets (rows, order and zero padding), receive counts and
    route drops, with words >= 2^31 and duplicate rows."""
    rows, valid = _rows(m + w + s, m, w, high=True)
    want = ref_shard.route_states(jnp.asarray(rows), jnp.asarray(valid), s,
                                  cap_recv)
    got = shard.route_states(bitset.to_words(rows, "cpu"),
                             torch.from_numpy(valid), s, cap_recv)
    np.testing.assert_array_equal(bitset.from_words(got[0]),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])
    if cap_recv < m // s:
        assert int(got[2]) > 0, "no owner overflowed its receive buffer"
    owner = np.asarray(ref_bloom.murmur3_words(jnp.asarray(rows),
                                               ref_bloom.SEED1)) % s
    assert np.array_equal(
        bloom.murmur3_words(bitset.to_words(rows, "cpu"),
                            bloom.SEED1).numpy() % s, owner)


@pytest.mark.parametrize("counts,ratio", [
    ([10, 0, 0, 0], 1.5), ([5, 5, 6, 5], 1.5), ([0, 0, 0, 0], 1.5),
    ([7, 1, 3], 1.0), ([1, 0], 1.5), ([100, 98, 97, 101], 1.0),
    ([3, 3, 3], 1.0)])
def test_donation_plan_matches_reference(counts, ratio):
    targets, trig, moved = ref_shard.donation_plan(
        jnp.asarray(counts, jnp.int32), ratio)
    got = shard.donation_plan(counts, ratio)
    assert got[0].tolist() == np.asarray(targets).tolist()
    assert (got[1], got[2]) == (bool(trig), int(moved))
    assert int(got[0].sum()) == sum(counts)


@pytest.mark.parametrize("counts", [[10, 0, 0, 0], [7, 1, 3], [0, 16, 2, 5]])
def test_repack_matches_reference(counts):
    s, cap, w = len(counts), 16, 2
    rows, _ = _rows(sum(counts), s * cap, w, high=True)
    states = rows.reshape(s, cap, w)
    targets, _, _ = ref_shard.donation_plan(jnp.asarray(counts, jnp.int32),
                                            1.0)
    want = ref_shard._repack(jnp.asarray(states),
                             jnp.asarray(counts, jnp.int32), targets)
    got = shard._repack(bitset.to_words(states, "cpu"),
                        torch.tensor(counts),
                        torch.from_numpy(np.array(targets)))
    np.testing.assert_array_equal(bitset.from_words(got), np.asarray(want))


def test_shard_frontiers_root_in_shard_zero():
    fr = frontier.shard_frontiers(3, 32, 2, "cpu")
    assert fr.states.shape == (3, 32, 2)
    assert fr.count.tolist() == [1, 0, 0] and fr.dropped.tolist() == [0] * 3


# ------------------------------------------------------------ sharded rungs

@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_sharded_rungs_match_reference_with_overflow(cfg):
    """``decide_sharded`` on rungs whose per-shard buffer overflows (local,
    routing and owner drops) and on rungs that fit: verdict, inexact,
    expanded and the shard counters equal the reference's."""
    g = ref_graph.myciel(4)
    clique = [0, 1]
    kw = dict(block=32, m_bits=1 << 12, k_hashes=4, **cfg)
    for k, cap, s in [(8, 64, 3), (9, 64, 4), (10, 32, 2), (9, 1024, 2)]:
        ref_tr, port_tr = ref_telemetry.Tracker(), telemetry.Tracker()
        want = ref_shard.decide_sharded(g, k, clique, shards=s, cap=cap,
                                        schedule="doubling", tracker=ref_tr,
                                        **kw)
        got = shard.decide_sharded(_port_graph(g), k, clique, shards=s,
                                   cap=cap, device="cpu", tracker=port_tr,
                                   **kw)
        assert (got.feasible, got.inexact, got.expanded) == \
            (want.feasible, want.inexact, want.expanded), (k, cap, s)
        assert _counters(port_tr) == _counters(ref_tr), (k, cap, s)
        if cap == 32:
            assert got.inexact


def test_sharded_rung_plans_capacity_and_pads_n():
    """``cap=None`` plans ``plan_capacity(n, W, lanes=shards)``; ``n_pad``
    embeds the graph in a larger vertex space; a trivial target returns
    without work."""
    g = ref_graph.petersen()
    for kw in (dict(), dict(n_pad=40)):
        want = ref_shard.decide_sharded(g, 3, (), shards=2, block=32,
                                        schedule="doubling", **kw)
        got = shard.decide_sharded(_port_graph(g), 3, (), shards=2,
                                   block=32, device="cpu", **kw)
        assert (got.feasible, got.inexact, got.expanded) == \
            (want.feasible, want.inexact, want.expanded)
    assert shard.decide_sharded(_port_graph(g), 9, (), shards=2,
                                device="cpu").expanded == 0
    with pytest.raises(ValueError, match="n_pad"):
        shard.decide_sharded(_port_graph(g), 3, (), shards=2, n_pad=4,
                             device="cpu")


def test_shard_capability_checks():
    g = _port_graph(oracle.make_graph("petersen"))
    backend.validate("torch", shards=4)
    backend.validate("cuda", shards=4, mode="bloom", m_bits=1 << 10)
    with pytest.raises(backend.BackendCapabilityError, match="shards must"):
        solver.solve(g, shards=0, device="cpu")
    with pytest.raises(backend.BackendCapabilityError, match="CUDA device"):
        solver.solve(g, shards=2, backend="cuda", device="cpu")
    # a mesh of several ranks is the distributed solver, exact owner
    # dedup only (its parity: tests/test_torch_distributed_ckpt.py)
    mesh = type("Mesh", (), {"devices": np.empty(2, dtype=object),
                             "device": torch.device("cpu")})()
    with pytest.raises(backend.BackendCapabilityError,
                       match="exact owner dedup only"):
        shard.decide_sharded(g, 3, (), shards=2, device="cpu", mesh=mesh,
                             mode="bloom")
    old = backend.BATCHED_BACKENDS
    backend.BATCHED_BACKENDS = ("torch",)
    try:
        with pytest.raises(backend.BackendCapabilityError,
                           match="sharded engine"):
            backend.validate("cuda", shards=2)
    finally:
        backend.BATCHED_BACKENDS = old


def _cli(*args):
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve", *args],
        cwd=root, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})


@pytest.mark.parametrize("flags,kw", [
    (["--shards", "2"], dict(shards=2)),
    (["--shards", "4", "--donate-ratio", "1.0"],
     dict(shards=4, donate_ratio=1.0)),
    (["--heuristics", "4", "--seed", "3"], dict(heuristics=4, seed=3))],
    ids=["shards", "donate-ratio", "heuristics"])
def test_cli_prints_the_reference_line(flags, kw):
    want = ref_solver.solve(oracle.make_graph("queen5_5"), block=1 << 10,
                            **kw)
    out = _cli("--graph", "queen5_5", "--device", "cpu", *flags)
    assert out.returncode == 0, out.stderr
    assert (f"[solve] treewidth={want.width} exact={want.exact} "
            f"lb={want.lb} ub={want.ub} states_expanded={want.expanded}"
            ) in out.stdout


def test_cli_rejects_what_is_not_ported():
    # --distributed runs (tests/test_torch_distributed_ckpt.py); the cuda
    # backend on the CPU is rejected before any rank starts
    out = _cli("--graph", "petersen", "--device", "cpu", "--distributed",
               "--devices", "2", "--backend", "cuda")
    assert out.returncode == 2 and "CUDA device" in out.stderr
    out = _cli("--graph", "petersen", "--device", "cpu", "--shards", "0")
    assert out.returncode == 2 and "shards must be" in out.stderr
