"""The port's solve service against the reference's: scheduler parity,
memory planning, the slot pool and ``launch.twserve``.

Twins of ``tests/test_twserve.py``.  Every scenario runs through the
reference ``TwScheduler`` (JAX on the CPU) and the port's
(``device="cpu"``), and each request's result surface and event stream
must be equal (``serve_twins``; only clocked fields are dropped).  The
reference's own claims (parity with sequential ``solve``, fewer
dispatches, planned footprints) are asserted on the port as well.
"""
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest

from serve_twins import (Events, PORT, REF, one_torch_thread, record, sched,
                         solve, surface, twin)  # noqa: F401
from repro.core import batch as ref_batch
from repro.core import frontier as ref_frontier
from repro_torch.core import backend as backend_lib
from repro_torch.core import batch, bitset, frontier
from repro_torch.serve.slots import SlotPool

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCK = 32
FAST = dict(cap=1 << 12, block=BLOCK)


def _request_stream(pkg):
    g = pkg.graph
    return [g.petersen(), g.myciel(3), g.grid(3, 4), g.gnp(12, 0.3, 7),
            g.desargues(), g.petersen()]


def _serve(pkg, gs, *, lanes=3, reconstruct=False, **kw):
    s = sched(pkg, lanes=lanes, **kw)
    ev = Events()
    rids = [s.submit(g, reconstruct=reconstruct, on_event=ev) for g in gs]
    s.run()
    return s, rids, ev


# ------------------------------------------------------------ result parity

def test_service_matches_sequential_solve_with_fewer_dispatches():
    def scenario(pkg):
        gs = _request_stream(pkg)
        pkg.engine.reset_counters()
        seq = [surface(solve(pkg, g, **FAST)) for g in gs]
        seq_c = dict(pkg.engine.COUNTERS)
        pkg.engine.reset_counters()
        s, rids, ev = _serve(pkg, gs, **FAST)
        srv_c = dict(pkg.engine.COUNTERS)
        rec = record(s, rids, ev)
        rec["seq"] = seq
        rec["_counters"] = (seq_c, srv_c, s.rounds)
        return rec

    _ref, port = twin(scenario)
    assert list(port["results"].values()) == port["seq"]
    seq_c, srv_c, rounds = port["_counters"]
    assert srv_c["dispatches"] < seq_c["dispatches"]
    assert srv_c["host_syncs"] < seq_c["host_syncs"]
    assert rounds == srv_c["dispatches"]


@pytest.mark.parametrize("ref_backend,mode", [("jax", "sort"),
                                              ("jax", "bloom"),
                                              ("pallas", "sort")])
def test_service_backend_mode_matrix(ref_backend, mode):
    """The reference on each of its backends against the port's plain
    ``torch`` ops (the ``cuda`` kernels run only on the card:
    ``tests/test_torch_cuda.py``).  Every instance fits one 32-vertex
    word, so Bloom is bit-identical to the solo runs too."""
    def scenario(pkg):
        g = pkg.graph
        gs = [g.petersen(), g.myciel(3), g.grid(3, 4)]
        kw = dict(cap=1 << 12, block=BLOCK, mode=mode, m_bits=1 << 14,
                  schedule="doubling",
                  backend=ref_backend if pkg is REF else "torch")
        seq = [surface(solve(pkg, x, **kw)) for x in gs]
        s, rids, ev = _serve(pkg, gs, lanes=2, **kw)
        rec = record(s, rids, ev)
        rec["seq"] = seq
        return rec

    _ref, port = twin(scenario)
    assert list(port["results"].values()) == port["seq"]


def test_service_reconstruction_parity():
    def scenario(pkg):
        gs = [pkg.graph.petersen(), pkg.graph.queen(5)]
        seq = [surface(solve(pkg, g, reconstruct=True, **FAST))
               for g in gs]
        s, rids, ev = _serve(pkg, gs, lanes=2, reconstruct=True, **FAST)
        rec = record(s, rids, ev)
        rec["seq"] = seq
        rec["order_widths"] = [pkg.solver.order_width(g, s.done[r].order)
                               for g, r in zip(gs, rids)]
        return rec

    _ref, port = twin(scenario)
    assert list(port["results"].values()) == port["seq"]
    assert port["order_widths"] == [r[0] for r in port["seq"]]


def test_service_reconstruction_stitches_articulated_instances():
    def scenario(pkg):
        adj = np.zeros((12, 12), dtype=bool)
        for u in range(5):
            for v in range(u + 1, 5):
                adj[u, v] = adj[v, u] = True
        for u in range(4, 9):
            for v in range(u + 1, 9):
                adj[u, v] = adj[v, u] = True
        adj[8, 9] = adj[9, 8] = adj[9, 10] = adj[10, 9] = True
        g = pkg.graph.Graph(12, adj, "barbell")
        ref = surface(solve(pkg, g, reconstruct=True, **FAST))
        s, rids, ev = _serve(pkg, [g, pkg.graph.petersen()], lanes=2,
                             reconstruct=True, **FAST)
        rec = record(s, rids, ev)
        rec["solo"] = ref
        rec["order_width"] = pkg.solver.order_width(g, s.done[rids[0]].order)
        return rec

    _ref, port = twin(scenario)
    got = port["results"][0]
    assert sorted(got[6]) == list(range(12))
    assert got[6] == port["solo"][6]
    assert port["order_width"] <= got[0] == port["solo"][0]


def test_more_requests_than_lanes_fifo_recycling():
    def scenario(pkg):
        g = pkg.graph
        gs = [g.petersen(), g.myciel(3), g.grid(3, 4), g.petersen(),
              g.gnp(11, 0.35, 3), g.myciel(3), g.grid(2, 5)]
        s, rids, ev = _serve(pkg, gs, lanes=2, **FAST)
        rec = record(s, rids, ev)
        rec["seq"] = [surface(solve(pkg, x, **FAST)) for x in gs]
        return rec

    _ref, port = twin(scenario)
    assert list(port["results"].values()) == port["seq"]
    assert sorted(port["results"]) == list(range(7))


def test_trivial_requests_never_occupy_a_lane():
    def scenario(pkg):
        G = pkg.graph
        empty = G.Graph(0, np.zeros((0, 0), dtype=bool), "empty")
        single = G.Graph(1, np.zeros((1, 1), dtype=bool), "single")
        gs = [empty, single, G.complete(5)]
        pkg.engine.reset_counters()
        s, rids, ev = _serve(pkg, gs, lanes=2, **FAST)
        rec = record(s, rids, ev)
        rec["_dispatches"] = dict(pkg.engine.COUNTERS)["dispatches"]
        rec["seq"] = [surface(solve(pkg, x, **FAST)) for x in gs]
        return rec

    _ref, port = twin(scenario)
    assert port["_dispatches"] == 0 and port["rounds"] == 0
    assert list(port["results"].values()) == port["seq"]


def test_service_start_k_and_forced_inexactness():
    def scenario(pkg):
        g = pkg.graph.petersen()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            seq = [surface(solve(pkg, g, use_preprocess=False, start_k=sk,
                                 **FAST)) for sk in (1, 4, 50)]
            s = sched(pkg, lanes=2, use_preprocess=False, **FAST)
            ev = Events()
            rids = [s.submit(g, start_k=sk, on_event=ev)
                    for sk in (1, 4, 50)]
            s.run()
        rec = record(s, rids, ev)
        rec["seq"] = seq
        return rec

    _ref, port = twin(scenario)
    assert list(port["results"].values()) == port["seq"]


def test_service_validates_configuration_at_construction():
    with pytest.raises(backend_lib.BackendCapabilityError):
        sched(PORT, lanes=2, schedule="while")
    with pytest.raises(backend_lib.BackendCapabilityError):
        sched(PORT, lanes=2, backend="cuda")       # the CPU has no kernels
    with pytest.raises(backend_lib.BackendCapabilityError):
        sched(PORT, lanes=2, mode="nope")
    with pytest.raises(ValueError):
        sched(PORT, lanes=0)


# --------------------------------------------------------- memory planning

@pytest.mark.parametrize("n,w,lanes,block,cap_max,budget", [
    (6, 1, 8, 1 << 11, 1 << 18, None), (10, None, 1, 1 << 11, 1 << 18, None),
    (14, 1, 8, 32, 1 << 17, 8 * 1024 * 4), (14, 1, 8, 32, 1 << 17, 1),
    (25, None, 1, 1 << 11, 100_000, None), (64, None, 1, 1 << 11, 1 << 12,
                                            None),
    (14, 1, 8, 1 << 11, 1 << 17, "auto"), (1, None, 1, 32, 1 << 17, None)])
def test_plan_capacity_equals_reference(n, w, lanes, block, cap_max, budget):
    kw = dict(lanes=lanes, block=block, cap_max=cap_max, budget_bytes=budget)
    assert batch.plan_capacity(n, w, **kw) == \
        ref_batch.plan_capacity(n, w, **kw)


def test_decide_lanes_auto_cap_parity():
    """decide_lanes(cap=None) plans from its largest lane and gives the
    fixed-cap lanes' verdicts, as the reference's does."""
    kw = dict(block=BLOCK, mode="sort", use_mmw=False, m_bits=1 << 12,
              k_hashes=4)
    out = []
    for pkg, extra in ((PORT, {"device": "cpu"}),
                       (REF, {"schedule": "while"})):
        G = pkg.graph
        lanes = [batch.Lane(g, k) if pkg is PORT else ref_batch.Lane(g, k)
                 for g in (G.petersen(), G.myciel(3), G.grid(3, 4))
                 for k in (2, 4)]
        mod = batch if pkg is PORT else ref_batch
        for cap in (None, 1 << 12):
            out.append([(r.feasible, r.inexact, r.expanded) for r in
                        mod.decide_lanes(lanes, cap=cap, **kw, **extra)])
    assert out[0] == out[1] == out[2] == out[3]


def test_scheduler_budget_survives_word_count_growth():
    def scenario(pkg):
        budget = 2 * 1024 * 1 * 4
        s = sched(pkg, lanes=2, block=BLOCK, budget_bytes=budget)
        r0 = s.submit(pkg.graph.petersen())
        s.run()
        caps = [sorted(s._cap_pad.values())]  # keys name the backend
        r1 = s.submit(pkg.graph.grid(5, 8))
        s.run()
        caps.append(sorted(s._cap_pad.values()))
        rec = record(s, [r0, r1])
        rec.update(caps=caps, n_pad=s._n_pad, pool_bytes=s.pool_bytes())
        return rec

    _ref, port = twin(scenario)
    budget = 2 * 1024 * 4
    assert max(port["caps"][0]) * 2 * 1 * 4 <= budget
    w = bitset.n_words(port["n_pad"])
    assert w == 2
    assert max(port["caps"][1]) * 2 * w * 4 <= budget
    assert port["pool_bytes"] <= budget


def test_service_pool_bytes_reports_planned_footprint():
    def scenario(pkg):
        s, rids, ev = _serve(pkg, [pkg.graph.petersen(),
                                   pkg.graph.myciel(3)], lanes=4,
                             block=BLOCK)
        rec = record(s, rids, ev)
        rec["pool_bytes"] = s.pool_bytes()
        return rec

    _ref, port = twin(scenario)
    fixed_pool = frontier.frontier_bytes(batch.DEFAULT_CAP,
                                         bitset.n_words(32), lanes=4)
    assert 0 < port["pool_bytes"] < fixed_pool
    assert fixed_pool == ref_frontier.frontier_bytes(
        ref_batch.DEFAULT_CAP, 1, lanes=4)


# -------------------------------------------------------------- slot pool

def _pool_trace(SlotPool_):
    out = []
    pool = SlotPool_(2)
    for x in "abcd":
        pool.submit(x)
    out.append(pool.admit(lambda x: x.upper()))
    out.append(pool.active())
    pool.release(0)
    out.append(pool.admit(lambda x: x.upper()))
    out.append(pool.busy)
    pool.release(0)
    pool.release(1)
    out.append(pool.admit(lambda x: x.upper()))
    pool.release(0)
    out.append(pool.busy)
    one = SlotPool_(1)
    for x in [0, 0, 3, 5]:
        one.submit(x)
    out.append(one.admit(lambda x: x if x else None))
    out.append(list(one.queue))
    return out


def test_slot_pool_fifo_admission_and_recycling():
    from repro.serve.slots import SlotPool as RefSlotPool
    got = _pool_trace(SlotPool)
    assert got == _pool_trace(RefSlotPool)
    assert got[0] == [(0, "A"), (1, "B")]
    assert got[2] == [(0, "C")] and got[4] == [(0, "D")]
    assert got[6] == [(0, 3)] and got[7] == [5]
    assert got[5] is False
    with pytest.raises(ValueError):
        SlotPool(0)


# ---------------------------------------------------------------- the CLI

def _cli(module, *args):
    out = subprocess.run(
        [sys.executable, "-m", module, "--graphs", "petersen,queen5_5",
         "--compare", *args], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"PYTHONPATH": str(ROOT / "src"),
                          "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                          "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    return out.stdout.splitlines()


def test_twserve_compare_prints_the_reference_lines():
    """``python -m repro_torch.launch.twserve --compare`` keeps its parity
    assertion and prints the reference's request lines."""
    port = _cli("repro_torch.launch.twserve", "--device", "cpu")
    ref = _cli("repro.launch.twserve")
    req = [ln for ln in port if ln.startswith("[twserve] req")]
    assert req == [ln for ln in ref if ln.startswith("[twserve] req")]
    assert req[1] == ("[twserve] req 1 (queen5_5): width=18 exact=True "
                      "lb=12 ub=18 expanded=2279")
    assert "parity OK" in port[-1]


def test_twserve_rejects_unported_schedules():
    from repro_torch.launch import twserve
    assert twserve.main(["--graphs", "petersen", "--device", "cpu",
                         "--schedule", "while"]) == 2
    assert twserve.main(["--graphs", "nope", "--device", "cpu"]) == 2
