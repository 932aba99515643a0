"""Sharded requests through the port's solve service against the
reference's: multi-slot admission, cancel and deadline of a slot group,
priorities, backpressure and the scale-out round count.

Twins of ``tests/test_twserve_shards.py`` (``serve_twins``: equal result
surfaces and event streams; only clocked fields are dropped).  The
port's sharded rungs run inside ``launch()``, so cancel and deadline of a
running sharded request act at rung boundaries; the values are the
reference's.
"""
import time

import pytest

from serve_twins import (Events, PORT, REF, one_torch_thread, record, sched,
                         solve, surface, twin)  # noqa: F401
from repro_torch.core import graph

BLOCK = 32
FAST = dict(cap=1 << 12, block=BLOCK)


# ------------------------------------------------ SlotPool multi-slot width

def _group_trace(pkg):
    out = []
    pool = pkg.SlotPool(4, slots_of=lambda it: it[1])
    pool.submit(("wide", 3)); pool.submit(("a", 1)); pool.submit(("b", 1))
    out.append([i for i, _ in pool.admit(lambda it: it)])
    out.append((pool.free, [i for i, _ in pool.active()]))
    pool.release(0)
    out.append(pool.free)
    out.append(pool.admit(lambda it: it))
    pool = pkg.SlotPool(2, slots_of=lambda it: it[1])
    pool.submit(("n1", 1))
    out.append(pool.admit(lambda it: it))
    pool.submit(("wide", 2)); pool.submit(("n2", 1))
    out.append(pool.admit(lambda it: it))
    pool.release(0)
    out.append(pool.admit(lambda it: it))
    out.append((pool.free, pool.qsize))
    return out


def test_slotpool_multislot_groups_and_head_of_line_admission():
    got = _group_trace(PORT)
    assert got == _group_trace(REF)
    assert got[:4] == [[0, 3], (0, [0, 3]), 3, [(0, ("b", 1))]]
    assert got[5] == [] and got[6] == [(0, ("wide", 2))]
    assert got[7] == (0, 1)


# ------------------------------------------------------ scheduler admission

def test_sharded_submit_validates_against_pool_size():
    s = sched(PORT, lanes=2, **FAST)
    with pytest.raises(ValueError):
        s.submit(graph.petersen(), shards=3)
    with pytest.raises(ValueError):
        s.submit(graph.petersen(), shards=0)
    with pytest.raises(ValueError):
        s.submit(graph.petersen(), shards=2, heuristic_only=True)


def test_sharded_request_occupies_shards_slots():
    def scenario(pkg):
        s = sched(pkg, lanes=4, **FAST)
        ev = Events()
        wide = s.submit(pkg.graph.queen(5), shards=3, on_event=ev)
        nar = s.submit(pkg.graph.petersen(), on_event=ev)
        assert s.launch()
        occupied = (s.pool.free, len(s.pool.active()))
        s.run()
        rec = record(s, [wide, nar], ev)
        rec["occupied"] = occupied
        rec["seq"] = surface(solve(pkg, pkg.graph.petersen(), **FAST))
        return rec

    _ref, port = twin(scenario)
    assert port["occupied"] == (0, 2)
    assert port["results"][1] == port["seq"]


def test_mixed_stream_parity_with_sharded_and_narrow_requests(
        event_invariants):
    def scenario(pkg):
        g = pkg.graph
        gs = [(g.petersen(), 4), (g.myciel(3), 1), (g.queen(4), 2)]
        s = sched(pkg, lanes=4, **FAST)
        ev = Events()
        rids = [s.submit(x, shards=k, on_event=ev) for x, k in gs]
        s.run()
        rec = record(s, rids, ev)
        rec["seq"] = [surface(solve(pkg, x, **FAST)) for x, _ in gs]
        return rec

    _ref, port = twin(scenario)
    assert list(port["results"].values()) == port["seq"]
    for rid, evs in port["events"].items():
        assert event_invariants(evs, rid=rid)["event"] == "done"


# -------------------------------------------------- cancel / deadline / prio

def test_cancel_sharded_request_frees_the_whole_slot_group(
        event_invariants):
    def scenario(pkg):
        s = sched(pkg, lanes=4, **FAST)
        ev = Events()
        wide = s.submit(pkg.graph.queen(6), shards=4, on_event=ev)
        assert s.launch()
        free = [s.pool.free]
        assert s.cancel(wide)
        free.append(s.pool.free)
        s.run()
        rec = record(s, [wide], ev)
        rec["free"] = free
        return rec

    _ref, port = twin(scenario)
    assert port["free"] == [0, 4]
    assert port["results"][0] is None and port["terminal"][0] == "cancelled"
    assert event_invariants(port["events"][0], rid=0)["event"] == "cancelled"


def test_deadline_preempts_a_sharded_request_with_anytime_bounds(
        event_invariants):
    def scenario(pkg):
        s = sched(pkg, lanes=4, **FAST)
        ev = Events()
        rid = s.submit(pkg.graph.queen(6), shards=4, on_event=ev)
        assert s.launch()
        for _i, (req, _inst) in s.pool.active():
            req.deadline = time.monotonic() - 1.0
        s.run()
        rec = record(s, [rid], ev)
        rec["free"] = s.pool.free
        return rec

    _ref, port = twin(scenario)
    width, exact, lb, ub = port["results"][0][:4]
    assert not exact and lb <= 25 <= ub           # tw(queen6_6) = 25
    assert port["terminal"][0] == "timeout" and port["free"] == 4
    term = event_invariants(port["events"][0], rid=0)
    assert term["event"] == "done" and term["timed_out"] is True


def test_urgent_narrow_overtakes_a_queued_wide_request():
    def scenario(pkg):
        g = pkg.graph
        s = sched(pkg, lanes=2, **FAST)
        ev = Events()
        busy = s.submit(g.myciel(3), on_event=ev)
        wide = s.submit(g.queen(4), shards=2, on_event=ev)
        hi = s.submit(g.petersen(), priority=5, on_event=ev)
        order = []
        start = s._start

        def spy(req):
            order.append(req.rid)
            return start(req)

        s._start = spy
        s.run()
        rec = record(s, [busy, wide, hi], ev)
        rec["order"] = order
        rec["seq"] = [surface(solve(pkg, x, **FAST))
                      for x in (g.myciel(3), g.queen(4), g.petersen())]
        return rec

    _ref, port = twin(scenario)
    assert port["order"] == [2, 0, 1]
    assert list(port["results"].values()) == port["seq"]


def test_bounded_queue_sheds_sharded_submits_too():
    s = sched(PORT, lanes=2, max_queue=1, **FAST)
    s.submit(graph.petersen(), shards=2)
    with pytest.raises(PORT.QueueFull) as ei:
        s.submit(graph.myciel(3), shards=2)
    assert ei.value.retry_after is not None


# ----------------------------------------------------- scale-out regression

def test_sharded_heavy_request_finishes_in_fewer_rounds():
    def scenario(pkg):
        g = pkg.graph
        heavy, smalls = g.myciel(4), [g.myciel(3), g.petersen()]
        out = {"seq": [surface(solve(pkg, x, block=1 << 10))
                       for x in [heavy] + smalls]}
        for k in (1, 4):
            s = sched(pkg, lanes=4, block=1 << 10)
            ev = Events()
            rids = [s.submit(heavy, shards=k, on_event=ev)]
            rids += [s.submit(x, on_event=ev) for x in smalls]
            s.run()
            out[k] = record(s, rids, ev)
            out[k]["done_round"] = next(e["rounds"] for e in ev.of(rids[0])
                                        if e["event"] == "done")
        return out

    _ref, port = twin(scenario)
    for k in (1, 4):
        assert list(port[k]["results"].values()) == port["seq"]
    assert port[4]["done_round"] < port[1]["done_round"]
