"""Port parity: sharded solves (``solve(shards=S)``), the half of
``tests/test_torch_shard.py`` that runs whole solves, split from it so
that the two files run side by side.

The port's ``solve(shards=S)`` is held against the reference's and
against the port's own unsharded solve, which sharding leaves unchanged
in sort mode without overflow: the parity matrix, instances, forced
donation, overflow, the ``shards=1`` and host-engine aliases and the
sharded reconstruction.
"""

import pytest
import torch

import oracle
from repro.core import solver as ref_solver
from repro.core import telemetry as ref_telemetry
from repro_torch.core import graph, solver, telemetry

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


def _result(r):
    return (r.width, r.exact, r.lb, r.ub, r.expanded, r.per_k)


def _counters(tr, keys=SHARD_KEYS):
    c = tr.snapshot()["counters"]
    g = tr.snapshot().get("gauges", {})
    return {k: c.get(k, g.get(k, 0)) for k in keys}


# ----------------------------------------------------------- parity matrix

@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
@pytest.mark.parametrize("s", [2, 3, 4])
def test_sharded_solve_parity_matrix(cfg, s):
    """petersen at block=64: the port's ``solve(shards=S)`` equals the
    port's unsharded solve and the reference's ``solve(shards=S)``."""
    g = oracle.make_graph("petersen")
    kw = dict(block=BLOCK, **cfg)
    plain = solver.solve(_port_graph(g), device="cpu", **kw)
    want = ref_solver.solve(g, shards=s, **kw)
    got = solver.solve(_port_graph(g), shards=s, device="cpu", **kw)
    assert got.width == 4
    assert _result(got) == _result(want) == _result(plain)


@pytest.mark.parametrize("name,s", [("myciel3", 2), ("myciel3", 4),
                                    ("queen5_5", 2), ("queen5_5", 4)])
def test_sharded_solve_parity_across_instances(name, s):
    g = oracle.make_graph(name)
    plain = solver.solve(_port_graph(g), block=BLOCK, device="cpu")
    want = ref_solver.solve(g, shards=s, block=BLOCK)
    got = solver.solve(_port_graph(g), shards=s, block=BLOCK, device="cpu")
    assert _result(got) == _result(want) == _result(plain)


@pytest.mark.parametrize("mode", ["sort", "bloom"])
def test_forced_donation_fires_and_keeps_results(mode):
    """``donate_ratio=1.0`` rebalances every skewed level: the shard
    counters fire, equal the reference's, and the results do not move."""
    g = oracle.make_graph("myciel3")
    kw = dict(block=BLOCK, mode=mode)
    ref_tr, port_tr = ref_telemetry.Tracker(), telemetry.Tracker()
    plain = solver.solve(_port_graph(g), device="cpu", **kw)
    want = ref_solver.solve(g, shards=4, donate_ratio=1.0, tracker=ref_tr,
                            **kw)
    got = solver.solve(_port_graph(g), shards=4, donate_ratio=1.0,
                       device="cpu", tracker=port_tr, **kw)
    c = _counters(port_tr)
    assert c["shard_donations"] > 0 and c["shard_donated_rows"] > 0
    assert c == _counters(ref_tr)
    assert _result(got) == _result(want) == _result(plain)


@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_overflowing_sharded_solve_matches_reference(cfg):
    """A per-shard cap small enough to drop states: ``dropped`` shows as
    inexact rungs, and every value equals the reference's sharded run."""
    g = oracle.make_graph("queen5_5")
    kw = dict(cap=64, block=32, m_bits=1 << 12, k_hashes=4, **cfg)
    want = ref_solver.solve(g, shards=3, **kw)
    got = solver.solve(_port_graph(g), shards=3, device="cpu", **kw)
    assert _result(got) == _result(want)
    assert any(v["inexact"] for v in got.per_k.values()
               for v in v.values()), "no rung overflowed"


# ------------------------------------------------------------- the aliases

def test_one_shard_is_the_unsharded_path():
    """``shards=1`` runs the plain path: the same results and the same
    counter trace as a call without the knob."""
    g = _port_graph(oracle.make_graph("petersen"))
    ref_tr, tr = telemetry.Tracker(), telemetry.Tracker()
    plain = solver.solve(g, block=BLOCK, device="cpu", tracker=ref_tr)
    got = solver.solve(g, block=BLOCK, shards=1, device="cpu", tracker=tr)
    assert _result(got) == _result(plain) and got.order == plain.order
    assert tr.snapshot()["counters"] == ref_tr.snapshot()["counters"]
    assert "shard_idle_steps" not in tr.snapshot()["counters"]


def test_shards_force_one_lane_and_fall_back_under_the_host_engine():
    g = oracle.make_graph("queen5_5")
    want = ref_solver.solve(g, block=BLOCK)
    for kw in (dict(shards=2, lanes=3), dict(shards=2, engine="host")):
        got = solver.solve(_port_graph(g), block=BLOCK, device="cpu", **kw)
        assert _result(got) == _result(want), kw


@pytest.mark.parametrize("name", ["petersen", "myciel3", "queen5_5"])
def test_sharded_reconstruction_replays_within_the_width(name):
    g = oracle.make_graph(name)
    want = ref_solver.solve(g, shards=2, block=BLOCK, reconstruct=True)
    got = solver.solve(_port_graph(g), shards=2, block=BLOCK,
                       reconstruct=True, device="cpu")
    assert _result(got) == _result(want)
    assert got.order is not None and oracle.order_is_valid(g, got.order)
    assert solver.order_width(_port_graph(g), got.order) <= got.width
