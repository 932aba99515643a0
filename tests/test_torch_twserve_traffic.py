"""The port's traffic shaping and telemetry scoping against the
reference's: cancel, deadlines, priorities, backpressure, pipelined
dispatch, lifecycle isolation and per-request scopes.

Twins of ``tests/test_twserve_traffic.py`` and the scheduler cases of
``tests/test_telemetry_scopes.py`` (``serve_twins``: equal result
surfaces and event streams; only clocked fields are dropped).

The port's dispatches run their whole rung inside ``launch()``, so a
``cancel`` of a running request and a ``pipeline=2`` overlap act at rung
boundaries.  The reference's assertions hold value for value: the
cancelled rid's verdicts are discarded uncounted, depth 2 syncs with a
round already queued (``covered_syncs``) and so idles fewer times.
"""
import threading
import time

import pytest

from serve_twins import (Events, PORT, REF, one_torch_thread, record, sched,
                         solve, surface, twin, unclock)  # noqa: F401
from repro_torch.core import graph
from repro_torch.serve.slots import QueueFull

BLOCK = 32
FAST = dict(cap=1 << 12, block=BLOCK)


class _Poisoned:
    """A graph-shaped object that explodes inside preprocessing."""
    n = 5
    name = "poisoned"
    adj = None


# ------------------------------------------------------ SlotPool mechanics

def _slot_traces(pkg):
    SlotPool_ = pkg.SlotPool
    out = []
    pool = SlotPool_(1)
    pool.submit("lo1"); pool.submit("lo2")
    pool.submit("hi", priority=3)
    out.append(pool.queue)
    out.append([pool._pop() for _ in range(3)])
    pool = SlotPool_(1, prio_weight=2)
    for i in range(5):
        pool.submit(f"h{i}", priority=1)
    pool.submit("l0"); pool.submit("l1")
    out.append([pool._pop() for _ in range(7)])
    pool = SlotPool_(1, max_queue=2)
    pool.submit("a"); pool.submit("b")
    with pytest.raises(pkg.QueueFull):
        pool.submit("c")
    out.append(pool.qsize)
    pool.admit(lambda item: item)
    pool.submit("c")
    out.append(pool.queue)
    pool = SlotPool_(1)
    pool.submit("a"); pool.submit("b", priority=1)
    out.append([pool.discard(lambda it: it == "b"),
                pool.discard(lambda it: it == "b"), pool.queue])
    return out


def test_slotpool_priorities_weighted_fifo_bound_and_discard():
    got = _slot_traces(PORT)
    assert got == _slot_traces(REF)
    assert got[0] == ["hi", "lo1", "lo2"]
    assert got[2] == ["h0", "h1", "l0", "h2", "h3", "l1", "h4"]
    assert got[3] == 2
    assert got[5] == ["b", None, ["a"]]


# ----------------------------------------------------------- cancellation

def test_cancel_queued_request_never_runs(event_invariants):
    def scenario(pkg):
        s = sched(pkg, lanes=1, **FAST)
        ev = Events()
        keep = s.submit(pkg.graph.petersen(), on_event=ev)
        drop = s.submit(pkg.graph.myciel(3), on_event=ev)
        assert s.cancel(drop)
        st = s.status(drop)
        s.run()
        rec = record(s, [keep, drop], ev)
        rec["status"] = st
        rec["seq"] = surface(solve(pkg, pkg.graph.petersen(), **FAST))
        return rec

    _ref, port = twin(scenario)
    assert port["status"] == {"state": "cancelled"}
    assert port["results"][0] == port["seq"] and port["results"][1] is None
    assert event_invariants(port["events"][1], rid=1)["event"] == "cancelled"


def test_cancel_running_request_frees_the_lane_and_keeps_parity(
        event_invariants):
    def scenario(pkg):
        s = sched(pkg, lanes=2, **FAST)
        ev = Events()
        slow = s.submit(pkg.graph.queen(6), on_event=ev)
        fast = s.submit(pkg.graph.petersen(), on_event=ev)
        assert s.launch()
        assert s.cancel(slow)
        free = s.pool.free
        s.run()
        rec = record(s, [slow, fast], ev)
        rec["free"] = free
        rec["seq"] = surface(solve(pkg, pkg.graph.petersen(), **FAST))
        return rec

    _ref, port = twin(scenario)
    assert port["free"] == 1
    assert port["results"][1] == port["seq"] and port["results"][0] is None
    assert port["terminal"][0] == "cancelled"
    assert event_invariants(port["events"][0], rid=0)["event"] == "cancelled"


def test_cancel_is_idempotent_and_safe_on_unknown_rids():
    s = sched(PORT, lanes=1, **FAST)
    rid = s.submit(graph.petersen())
    assert s.cancel(rid)
    assert not s.cancel(rid)
    assert not s.cancel(999)
    assert s.run() == {}


# --------------------------------------------------------------- deadlines

def test_deadline_preempts_mid_ladder_with_monotone_anytime_bounds(
        event_invariants):
    def scenario(pkg):
        s = sched(pkg, lanes=1, **FAST)
        ev = Events()
        rid = s.submit(pkg.graph.queen(6), on_event=ev)
        assert s.launch()
        for _i, (req, _inst) in s.pool.active():
            req.deadline = time.monotonic() - 1.0
        s.run()
        rec = record(s, [rid], ev)
        rec.update(status=s.status(rid), free=s.pool.free,
                   seq=surface(solve(pkg, pkg.graph.queen(6), **FAST)))
        return rec

    _ref, port = twin(scenario)
    width, exact, lb, ub, expanded = port["results"][0][:5]
    ref = port["seq"]
    assert not exact and lb <= ref[0] <= ub and expanded < ref[4]
    assert port["terminal"][0] == "timeout"
    assert port["status"]["timed_out"] is True and port["free"] == 1
    last = event_invariants(port["events"][0], rid=0)
    assert last["event"] == "done" and last["timed_out"] is True
    assert (last["lb"], last["ub"]) == (lb, ub)


def test_deadline_expired_while_queued_and_unhit_deadline():
    def scenario(pkg):
        s = sched(pkg, lanes=1, **FAST)
        ev = Events()
        r0 = s.submit(pkg.graph.queen(5), deadline_s=0.0, on_event=ev)
        r1 = s.submit(pkg.graph.petersen(), deadline_s=3600.0, on_event=ev)
        s.run()
        rec = record(s, [r0, r1], ev)
        rec["seq"] = surface(solve(pkg, pkg.graph.petersen(), **FAST))
        return rec

    _ref, port = twin(scenario)
    q = port["results"][0]
    assert not q[1] and q[4] == 0 and q[2] == 0 and q[3] == 24
    assert port["terminal"] == {0: "timeout", 1: "done"}
    assert port["results"][1] == port["seq"]


# -------------------------------------------------------------- priorities

def test_high_priority_requests_jump_the_admission_queue():
    def scenario(pkg):
        s = sched(pkg, lanes=1, **FAST)
        ev = Events()
        lo = s.submit(pkg.graph.myciel(3), on_event=ev)
        hi = s.submit(pkg.graph.petersen(), priority=5, on_event=ev)
        order = []
        start = s._start

        def spy(req):
            order.append(req.rid)
            return start(req)

        s._start = spy
        s.run()
        rec = record(s, [lo, hi], ev)
        rec["order"] = order
        return rec

    _ref, port = twin(scenario)
    assert port["order"][:2] == [1, 0]


# ------------------------------------------------------------ backpressure

def test_bounded_queue_rejects_with_a_retry_after_hint():
    s = sched(PORT, lanes=1, max_queue=1, **FAST)
    rid = s.submit(graph.petersen())
    with pytest.raises(QueueFull) as ei:
        s.submit(graph.myciel(3))
    assert ei.value.retry_after is not None and ei.value.retry_after > 0
    assert s._next_rid == rid + 1
    assert set(s.run()) == {rid}


# ------------------------------------------------------ pipelined dispatch

def test_pipeline_depth_2_matches_depth_1_with_fewer_idle_syncs():
    def scenario(pkg):
        g = pkg.graph
        suite = [g.queen(5), g.myciel(3), g.petersen()]
        out = {"seq": [surface(solve(pkg, x, **FAST)) for x in suite]}
        for depth in (1, 2):
            s = sched(pkg, lanes=3, pipeline=depth, **FAST)
            ev = Events()
            rids = [s.submit(x, on_event=ev) for x in suite]
            s.run()
            out[depth] = record(s, rids, ev)
            out[depth]["syncs"] = (s.idle_syncs, s.covered_syncs)
        return out

    _ref, port = twin(scenario)
    for depth in (1, 2):
        assert list(port[depth]["results"].values()) == port["seq"]
    assert port[1]["syncs"][1] == 0
    assert port[2]["syncs"][1] > 0
    assert port[2]["syncs"][0] < port[1]["syncs"][0]


def test_pipeline_guard_and_recover_after_failed_sync():
    def scenario(pkg):
        s = sched(pkg, lanes=1, pipeline=2, **FAST)
        rid = s.submit(pkg.graph.queen(5))
        assert s.launch() and s.launch()
        with pytest.raises(RuntimeError, match="in flight"):
            s.launch()
        no, handles, t0 = s._rounds[0]
        handle, metas = handles[0]
        handles[0] = (None, metas)
        with pytest.raises(AttributeError):
            s.sync()
        s.recover()
        assert not s.in_flight
        s.run()
        rec = record(s, [rid])
        rec["seq"] = surface(solve(pkg, pkg.graph.queen(5), **FAST))
        return rec

    _ref, port = twin(scenario)
    assert port["results"][0][:5] == port["seq"][:5]


# ----------------------------------------------------- lifecycle bugfixes

def test_poisoned_admission_is_isolated_and_emits_error(event_invariants):
    def scenario(pkg):
        s = sched(pkg, lanes=1, **FAST)
        ev = Events()
        bad = s.submit(_Poisoned(), on_event=ev)
        good = s.submit(pkg.graph.petersen(), on_event=ev)
        s.run()
        rec = record(s, [bad, good], ev)
        rec.update(error=s.errors[bad], status=s.status(bad))
        return rec

    _ref, port = twin(scenario)
    assert port["terminal"][0] == "error"
    assert "AttributeError" in port["error"]
    assert [e["event"] for e in port["events"][0]] == ["admitted", "error"]
    assert event_invariants(port["events"][0], rid=0)["event"] == "error"
    assert port["status"]["state"] == "error"
    assert port["results"][1][:2] == (4, True)


def test_event_sinks_run_outside_the_scheduler_lock():
    s = sched(PORT, lanes=1, **FAST)
    lock_free = []

    def probe(ev):
        got = []

        def try_lock():
            ok = s._lock.acquire(timeout=5)
            if ok:
                s._lock.release()
            got.append(ok)

        t = threading.Thread(target=try_lock)
        t.start()
        t.join()
        lock_free.append(got[0])

    rid = s.submit(graph.petersen(), on_event=probe)
    done = s.run()
    assert lock_free and all(lock_free)
    assert done[rid].width == 4


def test_event_ordering_guarantees_survive_deferred_delivery(
        event_invariants):
    def scenario(pkg):
        s = sched(pkg, lanes=2, **FAST)
        ev = Events()
        rid = s.submit(pkg.graph.queen(5), speculate=2, on_event=ev)
        s.run()
        return record(s, [rid], ev)

    _ref, port = twin(scenario)
    evs = port["events"][0]
    assert [e["seq"] for e in evs] == list(range(1, len(evs) + 1))
    assert event_invariants(evs, rid=0)["event"] == "done"
    ks = [e["k"] for e in evs if e["event"] == "rung_decided"]
    assert ks == sorted(ks) and ks


def test_duplicate_rid_is_rejected():
    s = sched(PORT, lanes=1, **FAST)
    rid = s.submit(graph.petersen())
    with pytest.raises(ValueError, match="already issued"):
        s.submit(graph.myciel(3), rid=rid)
    fresh = s.submit(graph.myciel(3), rid=rid + 7)
    assert fresh == rid + 7
    assert s.submit(graph.myciel(3)) == fresh + 1


def test_synthetic_overload_stream_degrades_gracefully():
    def scenario(pkg):
        g = pkg.graph
        s = sched(pkg, lanes=2, max_queue=2, prio_weight=2, **FAST)
        ev = Events()
        surv_a = s.submit(g.petersen(), on_event=ev)
        doomed = s.submit(g.queen(6), on_event=ev)
        assert s.launch()
        surv_b = s.submit(g.myciel(3), priority=1, on_event=ev)
        victim = s.submit(g.queen(5), on_event=ev)
        with pytest.raises(pkg.QueueFull) as ei:
            s.submit(g.myciel(4))
        assert ei.value.retry_after > 0
        assert s.cancel(victim)
        surv_c = s.submit(g.queen(5), on_event=ev)
        for _i, (req, _inst) in s.pool.active():
            if req.rid == doomed:
                req.deadline = time.monotonic() - 1.0
        s.run()
        rec = record(s, [surv_a, doomed, surv_b, victim, surv_c], ev)
        rec["seq"] = [surface(solve(pkg, x, **FAST))
                      for x in (g.petersen(), g.queen(6), g.myciel(3),
                                g.queen(5))]
        return rec

    _ref, port = twin(scenario)
    res, seq = port["results"], port["seq"]
    assert port["terminal"][3] == "cancelled" and res[3] is None
    assert port["terminal"][1] == "timeout" and not res[1][1]
    assert res[1][2] <= seq[1][0] <= res[1][3]
    assert (res[0], res[2], res[4]) == (seq[0], seq[2], seq[3])


# ------------------------------------------- telemetry scopes per request

RECON_KEYS = ("expanded", "rungs_decided", "rung_overflows")


def _reconcile(m):
    pool = m["pool"]["counters"]
    for key in RECON_KEYS:
        total = sum(s["counters"].get(key, 0)
                    for s in m["requests"].values())
        assert total == pool.get(key, 0), (key, total, m)


def _metrics(s):
    m = s.metrics()
    return {"pool": {k: v for k, v in m["pool"]["counters"].items()
                     if k in RECON_KEYS},
            "requests": {r: {k: v for k, v in snap["counters"].items()
                             if k in RECON_KEYS}
                         for r, snap in m["requests"].items()}}


def test_request_scopes_sum_to_pool_totals_across_cancel_and_deadline():
    """Per-request child scopes sum exactly into the pool scope on the
    rung counters, for a plain stream, a queued and an in-flight cancel,
    a deadline and a sharded request, as in the reference."""
    def scenario(pkg):
        g = pkg.graph
        s = sched(pkg, lanes=1, tracker=pkg.Tracker(), **FAST)
        ev = Events()
        r_live = s.submit(g.petersen(), on_event=ev)
        r_fly = s.submit(g.petersen(), on_event=ev)
        r_queued = s.submit(g.myciel(3), on_event=ev)
        assert s.launch()
        assert s.cancel(r_queued)
        s.sync()
        s.cancel(r_fly)
        s.run()
        t = sched(pkg, lanes=4, tracker=pkg.Tracker(), **FAST)
        ev_t = Events()
        r_dead = t.submit(g.myciel(3), deadline_s=0.0, on_event=ev_t)
        r_shard = t.submit(g.myciel(3), shards=2, on_event=ev_t)
        r_small = t.submit(g.petersen(), on_event=ev_t)
        t.run()
        m_s, m_t = s.metrics(), t.metrics()
        rec = record(s, [r_live, r_fly, r_queued], ev)
        rec.update(other=record(t, [r_dead, r_shard, r_small], ev_t),
                   counts=[_metrics(s), _metrics(t)],
                   _metrics=(m_s, m_t),
                   shard_dispatches=[
                       m_t["requests"][r_shard]["counters"].get(
                           "dispatches", 0) > 0,
                       m_t["requests"][r_small]["counters"].get(
                           "dispatches", 0)])
        return rec

    _ref, port = twin(scenario)
    m_s, m_t = port["_metrics"]
    _reconcile(m_s)
    _reconcile(m_t)
    assert port["terminal"] == {0: "done", 1: "cancelled", 2: "cancelled"}
    assert m_s["requests"][2]["counters"].get("rungs_decided", 0) == 0
    assert port["other"]["terminal"] == {0: "timeout", 1: "done", 2: "done"}
    assert port["shard_dispatches"] == [True, 0]
    for snap in m_s["requests"].values():
        assert "rounds" in snap["gauges"]
        assert snap["timings"]["request_s"]["calls"] == 1
    # each terminal event carries the snapshot the scheduler retains
    for rid, evs in port["events"].items():
        term = evs[-1]
        assert term["metrics"] == unclock(m_s["requests"][rid])
    assert port["events"][0][-1]["metrics"]["counters"]["expanded"] == \
        port["results"][0][4]


def test_pool_scope_isolated_per_scheduler_and_rid_filter():
    a = sched(PORT, lanes=1, **FAST)
    b = sched(PORT, lanes=1, **FAST)
    assert a.tracker is not b.tracker
    assert a.tracker.scope != b.tracker.scope
    ra = a.submit(graph.petersen())
    rb = a.submit(graph.petersen())
    a.run()
    assert a.metrics()["pool"]["counters"]["expanded"] > 0
    assert b.metrics()["pool"]["counters"].get("expanded", 0) == 0
    assert set(a.metrics(rid=ra)["requests"]) == {ra}
    assert a.metrics(rid=10_000)["requests"] == {}
    assert set(a.metrics()["requests"]) == {ra, rb}
    assert not b.metrics()["requests"]
