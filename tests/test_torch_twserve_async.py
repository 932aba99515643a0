"""The port's async streaming service against the reference's: dispatch
handles, event streams, per-request overrides and the overlap pipeline.

Twins of ``tests/test_twserve_async.py`` (``serve_twins``: equal result
surfaces and event streams; only clocked fields are dropped).

The port's dispatches run their whole rung before the handle returns, so
``DispatchHandle.ready()`` is true at once and admission "during a
flight" lands at a rung boundary.  The reference's scenarios still hold
value for value: the late arrival is admitted before the first round
syncs, into round 2, and its first rung rides round 2; the overlapped
stream finishes in fewer rounds than the two-phase one.  What does not
carry over is the reference's reading that the device was still busy
while that happened.
"""
import numpy as np
import pytest
import torch

from serve_twins import (Events, PORT, REF, one_torch_thread, record, sched,
                         solve, surface, twin)  # noqa: F401
from repro.core import batch as ref_batch
from repro.core import engine as ref_engine
from repro.core import graph as ref_graph
from repro_torch.core import backend as backend_lib
from repro_torch.core import batch, bitset, engine, graph

BLOCK = 32
FAST = dict(cap=1 << 12, block=BLOCK)
LANE_KW = dict(block=BLOCK, mode="sort", use_mmw=False, m_bits=1 << 12,
               k_hashes=4)


# ------------------------------------------------------- dispatch handles

def test_decide_lanes_async_matches_blocking_and_defers_the_sync():
    lanes = [batch.Lane(graph.petersen(), k) for k in (2, 3, 4)]
    engine.reset_counters()
    h = batch.decide_lanes_async(lanes, cap=1 << 12, device="cpu",
                                 **LANE_KW)
    c = dict(engine.COUNTERS)
    assert c["dispatches"] == 1 and c["host_syncs"] == 0
    res = h.result()
    assert engine.COUNTERS["host_syncs"] == 1
    assert h.result() is res
    assert engine.COUNTERS["host_syncs"] == 1
    blocking = batch.decide_lanes(lanes, cap=1 << 12, device="cpu",
                                  **LANE_KW)
    ref = ref_batch.decide_lanes(
        [ref_batch.Lane(ref_graph.petersen(), k) for k in (2, 3, 4)],
        cap=1 << 12, schedule="while", **LANE_KW)
    got = [(r.feasible, r.inexact, r.expanded) for r in res]
    assert got == [(r.feasible, r.inexact, r.expanded) for r in blocking]
    assert got == [(r.feasible, r.inexact, r.expanded) for r in ref]


def test_decide_lanes_async_empty_is_a_noop():
    engine.reset_counters()
    assert batch.decide_lanes_async([], device="cpu", **LANE_KW) \
        .result() == []
    assert all(v == 0 for v in engine.COUNTERS.values()), engine.COUNTERS


def test_fused_decide_launch_handle_parity():
    import jax.numpy as jnp
    from repro.core import bitset as ref_bitset
    g = graph.petersen()
    adj = bitset.to_words(g.packed(), "cpu")
    allowed = bitset.to_words(bitset.np_allowed(g.n, []), "cpu")
    kw = dict(n=g.n, cap=1 << 10, block=BLOCK, mode="sort", use_mmw=False,
              m_bits=1 << 12, k_hashes=4)
    h = engine.fused_decide_launch(adj, allowed, 3, g.n - 4, **kw)
    feas, inex, exp, fr = h.result()
    assert h.ready()
    feas2, inex2, exp2, fr2 = engine.fused_decide(adj, allowed, 3,
                                                  g.n - 4, **kw)
    assert (feas, inex, exp) == (feas2, inex2, exp2)
    assert int(fr.count) == int(fr2.count)
    assert torch.equal(fr.states, fr2.states)
    rg = ref_graph.petersen()
    rfeas, rinex, rexp, rfr = ref_engine.fused_decide(
        jnp.asarray(rg.packed()), jnp.asarray(ref_bitset.np_allowed(rg.n,
                                                                    [])),
        3, rg.n - 4, schedule="while", **kw)
    assert (feas, inex, exp) == (bool(rfeas), bool(rinex), int(rexp))
    n = int(fr.count)
    assert n == int(rfr.count)
    assert np.array_equal(fr.states[:n].numpy().view(np.uint32),
                          np.asarray(rfr.states)[:n])


# ------------------------------------------------------------- streaming

def _collect(pkg, s, gs, **per_req):
    ev = Events()
    rids = [s.submit(g, on_event=ev, **per_req) for g in gs]
    s.run()
    return rids, ev


def test_event_stream_order_and_monotone_bounds(event_invariants):
    def scenario(pkg):
        s = sched(pkg, lanes=2, **FAST)
        rids, ev = _collect(pkg, s, [pkg.graph.petersen(),
                                     pkg.graph.queen(5)])
        return record(s, rids, ev)

    _ref, port = twin(scenario)
    for rid, evs in port["events"].items():
        assert evs[0]["event"] == "admitted"
        d = event_invariants(evs, rid=rid)
        r = port["results"][rid]
        assert d["event"] == "done"
        assert (d["width"], d["exact"], d["expanded"]) == (r[0], r[1], r[4])
        assert d["ub"] == r[0]
        if r[1]:
            assert d["lb"] == r[0]


def test_streamed_per_k_deltas_reassemble_the_result_per_k():
    def scenario(pkg):
        s = sched(pkg, lanes=1, **FAST)
        rids, ev = _collect(pkg, s, [pkg.graph.queen(5)])
        rec = record(s, rids, ev)
        rec["seq"] = surface(solve(pkg, pkg.graph.queen(5), **FAST))
        return rec

    _ref, port = twin(scenario)
    got = {}
    for e in port["events"][0]:
        if e["event"] == "rung_decided":
            got.setdefault(e["block"], {})[e["k"]] = {
                "feasible": e["feasible"], "inexact": e["inexact"],
                "expanded": e["expanded"]}
    per_k = port["results"][0][5]
    assert got == {blk: pk for blk, pk in per_k.items() if pk}
    assert per_k == port["seq"][5]


def test_broken_event_sink_does_not_break_the_solve():
    def sink(ev):
        raise RuntimeError("boom")
    s = sched(PORT, lanes=1, **FAST)
    with pytest.warns(UserWarning, match="event sink"):
        rid = s.submit(graph.petersen(), on_event=sink)
        done = s.run()
    assert done[rid].width == 4


# -------------------------------------------------- per-request overrides

def test_mixed_per_request_configs_in_one_pool_match_solo_solves():
    def scenario(pkg):
        g = pkg.graph
        reqs = [(g.petersen(), {}), (g.myciel(3), {"mode": "bloom"}),
                (g.grid(3, 4), {"use_mmw": True}),
                (g.desargues(), {"cap": 1 << 11})]
        s = sched(pkg, lanes=4, block=BLOCK, m_bits=1 << 14, cap=1 << 12)
        pkg.engine.reset_counters()
        ev = Events()
        rids = [s.submit(x, on_event=ev, **kw) for x, kw in reqs]
        s.run()
        rec = record(s, rids, ev)
        rec["_dispatches"] = dict(pkg.engine.COUNTERS)["dispatches"]
        rec["solo"] = [surface(solve(
            pkg, x, block=BLOCK, m_bits=1 << 14, cap=kw.get("cap", 1 << 12),
            mode=kw.get("mode", "sort"), use_mmw=kw.get("use_mmw", False)))
            for x, kw in reqs]
        return rec

    _ref, port = twin(scenario)
    assert port["_dispatches"] > port["rounds"]
    for i, (a, b) in enumerate(zip(port["solo"],
                                   port["results"].values())):
        assert a[:4] == b[:4]
        if i != 2:          # MMW sees padding rows (the padded-lane caveat)
            assert (a[4], a[5]) == (b[4], b[5])


def test_per_request_speculate_keeps_parity_in_fewer_rounds():
    def scenario(pkg):
        g = pkg.graph.queen(5)
        one = sched(pkg, lanes=4, **FAST)
        r1 = one.submit(g)
        spec = sched(pkg, lanes=4, **FAST)
        r4 = spec.submit(g, speculate=4)
        one.run(), spec.run()
        return {"one": record(one, [r1]), "spec": record(spec, [r4]),
                "seq": surface(solve(pkg, g, **FAST))}

    _ref, port = twin(scenario)
    assert port["one"]["results"][0] == port["spec"]["results"][0] == \
        port["seq"]
    assert port["spec"]["rounds"] < port["one"]["rounds"]


def test_budget_splits_across_a_steps_concurrent_dispatches():
    def scenario(pkg):
        budget = 2 * 1024 * 1 * 4 * 2
        s = sched(pkg, lanes=2, block=BLOCK, budget_bytes=budget)
        r0 = s.submit(pkg.graph.petersen())
        r1 = s.submit(pkg.graph.myciel(3), use_mmw=True)
        assert s.launch()
        inflight = s.inflight_dispatches
        w = bitset.n_words(s._n_pad)
        resident = sum(cap * 2 * w * 4 for cap in s._cap_pad.values())
        s.sync()
        s.run()
        rec = record(s, [r0, r1])
        rec.update(inflight=inflight, resident=resident,
                   solo=[solve(pkg, pkg.graph.petersen(), block=BLOCK).width,
                         solve(pkg, pkg.graph.myciel(3), use_mmw=True,
                               block=BLOCK).width])
        return rec

    _ref, port = twin(scenario)
    assert port["inflight"] == 2
    assert port["resident"] <= 2 * 1024 * 4 * 2
    widths = [r[0] for r in port["results"].values()]
    assert all(w >= s for w, s in zip(widths, port["solo"]))


def test_recover_after_failed_step_keeps_serving():
    def scenario(pkg):
        s = sched(pkg, lanes=2, **FAST)
        ev = Events()
        rid = s.submit(pkg.graph.petersen(), on_event=ev)
        assert s.launch()
        no, handles, t0 = s._rounds[0]
        handle, metas = handles[0]
        handles[0] = (None, metas)              # .result() -> AttributeError
        with pytest.raises(AttributeError):
            s.sync()
        s.recover()
        assert not s.in_flight
        s.run()
        return record(s, [rid], ev)

    _ref, port = twin(scenario)
    assert port["results"][0][:2] == (4, True)


def test_per_request_capability_error_is_per_request():
    s = sched(PORT, lanes=2, **FAST)
    with pytest.raises(backend_lib.BackendCapabilityError):
        s.submit(graph.petersen(), mode="nope")
    with pytest.raises(ValueError):
        s.submit(graph.petersen(), cap=100)
    rid = s.submit(graph.petersen())
    assert s.run()[rid].width == 4


# ------------------------------------------------------- overlap pipeline

def test_late_arrival_is_admitted_during_an_inflight_dispatch():
    """Admitted before round 1's sync, into round 2, and its first rung
    rides round 2.  In the port the round-1 rung has already run when
    ``launch()`` returns (the handle is ready at once), so this is the
    reference's scenario at a rung boundary: values and event order are
    held; the device being busy meanwhile is not."""
    def scenario(pkg):
        s = sched(pkg, lanes=2, **FAST)
        ev = Events()
        r0 = s.submit(pkg.graph.queen(5), on_event=ev)
        pkg.engine.reset_counters()
        assert s.launch()
        assert s.in_flight
        syncs = [pkg.engine.COUNTERS["host_syncs"]]
        r1 = s.submit(pkg.graph.petersen(), on_event=ev)
        s.poll_admissions()
        syncs.append(pkg.engine.COUNTERS["host_syncs"])
        assert s.in_flight
        active = any(req.rid == r1 for _i, (req, _s) in s.pool.active())
        s.sync()
        s.run()
        rec = record(s, [r0, r1], ev)
        rec.update(syncs=syncs, active=active,
                   seq=[surface(solve(pkg, pkg.graph.queen(5), **FAST)),
                        surface(solve(pkg, pkg.graph.petersen(), **FAST))])
        return rec

    _ref, port = twin(scenario)
    assert port["syncs"] == [0, 0] and port["active"]
    evs = port["events"][1]
    admitted = [e for e in evs if e["event"] == "admitted"]
    assert admitted and admitted[0]["round"] == 2
    assert next(e for e in evs if e["event"] == "rung_started")["round"] == 2
    assert list(port["results"].values()) == port["seq"]


def test_overlap_beats_blocking_two_phase_round_count():
    def scenario(pkg):
        g = pkg.graph
        early, late = [g.queen(5)], [g.petersen(), g.myciel(3)]
        blocking = sched(pkg, lanes=4, **FAST)
        for x in early:
            blocking.submit(x)
        blocking.run()
        for x in late:
            blocking.submit(x)
        blocking.run()
        overlap = sched(pkg, lanes=4, **FAST)
        ev = Events()
        rids = [overlap.submit(x, on_event=ev) for x in early]
        assert overlap.launch()
        rids += [overlap.submit(x, on_event=ev) for x in late]
        overlap.poll_admissions()
        overlap.sync()
        overlap.run()
        rec = record(overlap, rids, ev)
        rec["blocking_rounds"] = blocking.rounds
        rec["seq"] = [surface(solve(pkg, x, **FAST)) for x in early + late]
        return rec

    _ref, port = twin(scenario)
    assert port["rounds"] < port["blocking_rounds"]
    assert list(port["results"].values()) == port["seq"]


def test_launch_twice_without_sync_is_an_error():
    s = sched(PORT, lanes=1, **FAST)
    s.submit(graph.petersen())
    assert s.launch()
    with pytest.raises(RuntimeError, match="in flight"):
        s.launch()
    s.sync()
    s.run()


def test_status_snapshots():
    def scenario(pkg):
        s = sched(pkg, lanes=1, **FAST)
        r0 = s.submit(pkg.graph.queen(5))
        r1 = s.submit(pkg.graph.petersen())
        states = [s.status(r0)]
        s.launch()
        states += [s.status(r0), s.status(r1), s.status(999)]
        s.sync()
        s.run()
        states.append(s.status(r0))
        rec = record(s, [r0, r1])
        rec["states"] = states
        return rec

    _ref, port = twin(scenario)
    st = port["states"]
    assert [x["state"] for x in st] == ["queued", "running", "queued",
                                        "unknown", "done"]
    assert st[-1]["width"] == port["results"][0][0]
