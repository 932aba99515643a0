"""The port's telemetry spans: ``Tracker.time_block`` as a profiler range on
the host timeline, the spans at planning, the level loop and every
device-to-host read (``preprocess_s``, ``plan_s`` with ``paths_s`` inside
it, ``rung_s``, ``level_s``, ``read_s``), and the process-wide
``d2h_bytes`` counter.  CPU only; no
reference needed."""
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import (batch, bitset, engine, graph, shard, solver,
                              telemetry)
from repro_torch.serve.twscheduler import TwScheduler

SPANS = ("preprocess_s", "plan_s", "paths_s", "rung_s", "level_s",
         "read_s")


def _root_delta(fn):
    """(fn(), counters delta, timings delta) of the process root."""
    s0 = telemetry.root().snapshot(children=False)
    out = fn()
    s1 = telemetry.root().snapshot(children=False)
    counters = {k: v - s0["counters"].get(k, 0)
                for k, v in s1["counters"].items()}
    timings = {k: v["calls"] - s0["timings"].get(k, {"calls": 0})["calls"]
               for k, v in s1["timings"].items()}
    return out, counters, timings


def test_solve_spans_are_host_ranges_inside_the_profile_window():
    g = graph.petersen()
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = solver.solve(g, block=32, device="cpu")
    t1 = time.time_ns()
    assert res.width == 4
    events = prof.profiler.kineto_results.events()
    start = prof.profiler.kineto_results.trace_start_ns()
    seen = {}
    for e in events:
        if e.name() in SPANS:
            seen[e.name()] = seen.get(e.name(), 0) + 1
            assert not e.is_user_annotation(), e.name()
            assert e.device_type() == torch.autograd.DeviceType.CPU
            # kineto's clock is epoch nanoseconds, as ``time.time_ns``
            assert t0 <= e.start_ns() <= e.end_ns() <= t1, e.name()
            assert e.start_ns() >= start
    assert set(seen) == set(SPANS), seen
    assert seen["preprocess_s"] == 1 and seen["plan_s"] == 1
    assert seen["paths_s"] == 1
    assert seen["read_s"] == seen["level_s"] + 2 * seen["rung_s"]


def test_span_record_carries_the_profiler_clock_and_its_parent():
    tr = telemetry.Tracker()
    sink = telemetry.InMemorySink()
    tr.add_sink(sink)
    t0 = time.time_ns()
    with tr.time_block("outer"):
        with tr.child("req").time_block("inner"):
            pass
    t1 = time.time_ns()
    inner, outer = sink.records
    assert (inner["name"], outer["name"]) == ("inner", "outer")
    assert inner["parent"] == "outer" and outer["parent"] is None
    assert inner["scope"] == "req"
    assert t0 <= outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] \
        <= outer["end_ns"] <= t1
    for r in (inner, outer):
        assert r["kind"] == "time"
        assert r["seconds"] <= (r["end_ns"] - r["start_ns"]) * 1e-9 + 1e-3
    snap = tr.snapshot()
    assert snap["timings"]["inner"]["calls"] == 1       # rolled up
    assert snap["timings"]["outer"]["calls"] == 1


def test_span_closes_on_exception_and_keeps_the_stack():
    tr = telemetry.Tracker()
    sink = telemetry.InMemorySink()
    tr.add_sink(sink)
    with pytest.raises(ValueError):
        with tr.time_block("failing"):
            raise ValueError("x")
    with tr.time_block("after"):
        pass
    assert [r["name"] for r in sink.records] == ["failing", "after"]
    assert sink.records[1]["parent"] is None


@pytest.mark.parametrize("k", [5, 4], ids=["feasible", "infeasible"])
def test_fused_decide_reads(k):
    """One count read a level, one more that ends the loop, and the
    result's copy; the bytes are those of the tensors read."""
    g = graph.myciel(3)
    cap, block = 64, 32
    adj = bitset.to_words(g.packed(), "cpu")
    allowed = bitset.to_words(bitset.np_allowed(g.n, []), "cpu")
    tr = telemetry.Tracker()

    def run():
        h = engine.fused_decide_launch(adj, allowed, k, g.n - (k + 1),
                                       n=g.n, cap=cap, block=block,
                                       tracker=tr)
        held = sum(a.nbytes for a in h.arrays
                   if isinstance(a, torch.Tensor))
        return h.result(), held

    ((feasible, _inexact, _exp, _fr), held), counters, _t = _root_delta(run)
    assert feasible == (k == 5)
    t = tr.snapshot()["timings"]
    levels = t["level_s"]["calls"]
    assert levels >= 1
    if feasible:
        assert levels == g.n - (k + 1)
    assert t["read_s"]["calls"] == levels + 2
    assert held == cap * bitset.n_words(g.n) * 4 + 4 + 4
    assert counters["d2h_bytes"] == (levels + 1) * 4 + held
    assert tr.snapshot()["counters"]["host_syncs"] == 1


def test_lane_dispatch_reads():
    g = graph.myciel(3)
    lanes = [batch.Lane(g, 5), batch.Lane(g, 4),
             batch.Lane(graph.petersen(), 4)]
    tr = telemetry.Tracker()

    def run():
        h = batch.decide_lanes_async(lanes, cap=64, block=32, mode="sort",
                                     use_mmw=False, m_bits=1 << 12,
                                     k_hashes=4, device="cpu", tracker=tr)
        held = sum(x.nbytes for x in h.arrays
                   if isinstance(x, torch.Tensor))
        return h.result(), held

    (verdicts, held), counters, _t = _root_delta(run)
    assert [v.feasible for v in verdicts] == [True, False, True]
    t = tr.snapshot()["timings"]
    levels = t["level_s"]["calls"]
    targets = [ln.g.n - (ln.k + 1) for ln in lanes]
    assert levels == max(targets)
    assert t["read_s"]["calls"] == levels + 2
    assert held == 2 * 4 * len(lanes)         # counts and drops, int32
    assert counters["d2h_bytes"] == (levels + 1) * 4 * len(lanes) + held


def test_host_engine_reads():
    """``run_level`` reads twice a level: its count in, its counts out."""
    g = graph.myciel(3)
    tr = telemetry.Tracker()
    res, counters, _t = _root_delta(lambda: solver.decide(
        g, 5, [], cap=64, block=32, engine="host", tracker=tr,
        device="cpu"))
    assert res.feasible
    levels = g.n - 6
    assert tr.snapshot()["timings"]["read_s"]["calls"] == 2 * levels
    assert "level_s" not in tr.snapshot()["timings"]
    # the count in is int32, the counts out int64
    assert counters["d2h_bytes"] == levels * (4 + 8 + 8)


@pytest.mark.parametrize("k", [5, 4], ids=["feasible", "infeasible"])
def test_sharded_decide_reads(k):
    """The sharded loop reads its (S,) counts once before the first level
    and once a level, and the result's copy makes one read more."""
    g = graph.myciel(3)
    shards = 2
    tr = telemetry.Tracker()

    def run():
        h = shard.decide_sharded_async(g, k, [], shards=shards, cap=256,
                                       block=32, device="cpu", tracker=tr)
        held = sum(a.nbytes for a in h.arrays
                   if isinstance(a, torch.Tensor))
        return h.result()[0], held

    (res, held), counters, _t = _root_delta(run)
    assert res.feasible == (k == 5)
    t = tr.snapshot()["timings"]
    levels = t["level_s"]["calls"]
    if res.feasible:
        assert levels == g.n - (k + 1)
    assert t["read_s"]["calls"] == levels + 2
    # the counts in are int32, each level's counts out int64
    assert counters["d2h_bytes"] == shards * 4 + levels * shards * 8 + held
    assert "d2h_bytes" not in tr.snapshot()["counters"]


@pytest.mark.parametrize("entry", ["solve", "solve_many"])
def test_planning_and_reads_land_on_the_root(entry):
    gs = [graph.myciel(3), graph.petersen()]
    if entry == "solve":
        def run():
            return [solver.solve(g, block=32, device="cpu") for g in gs]
    else:
        def run():
            return batch.solve_many(gs, lanes=4, block=32, device="cpu")
    res, counters, timings = _root_delta(run)
    assert [r.width for r in res] == [5, 4]
    assert timings.get("preprocess_s") == len(gs)
    assert timings.get("plan_s", 0) >= len(gs)
    assert timings.get("read_s", 0) > 0 and timings.get("level_s", 0) > 0
    assert counters.get("d2h_bytes", 0) > 0


def test_passed_tracker_gets_spans_but_no_d2h_bytes():
    tr = telemetry.Tracker()
    req = tr.child("req0")
    _r, counters, _t = _root_delta(lambda: solver.solve(
        graph.petersen(), block=32, device="cpu", tracker=req))
    assert counters["d2h_bytes"] > 0
    for scope in (tr, req):
        snap = scope.snapshot(children=False)
        assert "d2h_bytes" not in snap["counters"]
        assert {"preprocess_s", "plan_s", "rung_s", "level_s",
                "read_s"} <= set(snap["timings"])
    assert "dispatch_wall_s" not in tr.snapshot()["timings"]


def test_null_tracker_opens_no_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.NULL.time_block("null_probe_span"):
            torch.ones(2)
        with telemetry.Tracker().time_block("live_probe_span"):
            torch.ones(2)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "null_probe_span" not in names
    assert "live_probe_span" in names
    assert telemetry.NULL.snapshot()["timings"] == {}


def test_no_range_without_the_profiler():
    """With the profiler off a span opens no range (the flag check)."""
    assert not torch.autograd._profiler_enabled()
    blk = telemetry.Tracker().time_block("x")
    with blk:
        assert blk._range is None


def test_served_request_plans_in_its_own_scope():
    """Admission stamps the queue wait; the request's planning spans land
    in its scope and roll up to the pool."""
    s = TwScheduler(lanes=2, cap=1 << 12, block=32, device="cpu",
                    tracker=telemetry.Tracker())
    rids = [s.submit(graph.myciel(3)), s.submit(graph.petersen())]
    s.run()
    m = s.metrics()
    for rid in rids:
        t = m["requests"][rid]["timings"]
        assert t["admission_s"]["calls"] == 1
        assert t["preprocess_s"]["calls"] == 1
        assert t["plan_s"]["calls"] >= 1
        assert "d2h_bytes" not in m["requests"][rid]["counters"]
    pool = m["pool"]["timings"]
    assert pool["preprocess_s"]["calls"] == len(rids)
    assert pool["plan_s"]["calls"] == sum(
        m["requests"][r]["timings"]["plan_s"]["calls"] for r in rids)
    # the shared lane dispatches are the pool's: their reads land there
    assert pool["read_s"]["calls"] > 0
    assert "d2h_bytes" not in m["pool"]["counters"]


def test_span_parents_stay_on_their_thread():
    """Threads nest spans at once: each inner span's parent is its own
    thread's outer span, and no call is lost."""
    import sys
    import threading
    tr = telemetry.Tracker()
    sink = telemetry.InMemorySink()
    tr.add_sink(sink)
    n_threads, reps = 12, 200

    def work(i):
        for _ in range(reps):
            with tr.time_block(f"outer{i}"):
                with tr.child(f"t{i}").time_block(f"inner{i}"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    inner = [r for r in sink.records if r["name"].startswith("inner")]
    assert len(inner) == n_threads * reps
    for r in inner:
        assert r["parent"] == "outer" + r["name"][len("inner"):]
    t = tr.snapshot()["timings"]
    assert all(t[f"outer{i}"]["calls"] == reps for i in range(n_threads))


def _idle_tool():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "idle_by_span.py"
    spec = importlib.util.spec_from_file_location("idle_by_span", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_idle_by_span_cuts_gaps_by_the_innermost_span():
    tool = _idle_tool()
    s = int(1e9)        # one second in ns
    # device busy [0, 1], [3, 4], [4, 5] (touching), [9, 10]
    gaps = tool.device_gaps([(3 * s, 4 * s), (0, s), (4 * s, 5 * s),
                             (9 * s, 10 * s)])
    assert gaps == [(s, 3 * s), (5 * s, 9 * s)]
    # rung [0, 8] holds plan [2, 6] holding read [5, 5.5]; nothing after 8
    spans = [(0, 8 * s, "rung_s"), (2 * s, 6 * s, "plan_s"),
             (5 * s, 5 * s + s // 2, "read_s")]
    out = tool.idle_by_span(gaps, spans)
    assert out == pytest.approx({"rung_s": 1.0 + 2.0, "plan_s": 1.0 + 0.5,
                                 "read_s": 0.5, tool.NO_SPAN: 1.0})
    assert sum(out.values()) == pytest.approx(6.0)
    assert tool.idle_by_span(gaps, []) == pytest.approx(
        {tool.NO_SPAN: 6.0})


def test_idle_tool_reads_span_records_on_the_profiler_clock():
    """The tool's spans come from the sink's records, labelled by their
    parent, and the profiler's ranges of the same names start where the
    records do."""
    tool = _idle_tool()
    g = graph.petersen()
    tr = telemetry.Tracker()
    sink = telemetry.InMemorySink()
    tr.add_sink(sink)
    t0 = tr.snapshot(children=False)["timings"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = solver.solve(g, block=32, device="cpu", tracker=tr)
    t1 = tr.snapshot(children=False)["timings"]
    spans = tool.span_intervals(sink.records)
    labels = {label for _s, _e, label in spans}
    assert {"preprocess_s", "plan_s", "rung_s", "rung_s>level_s",
            "rung_s>read_s"} <= labels
    assert len(spans) == sum(v["calls"] for v in t1.values())
    ranges = [(e.start_ns(), e.end_ns(), e.name())
              for e in prof.profiler.kineto_results.events()
              if e.name() in SPANS]
    offs = tool.clock_offsets_us(sink.records, ranges)
    assert len(offs) == len(spans)
    # the range opens just before the record's clock is read
    assert all(-1000 < o <= 1000 for o in offs), offs
    sp = tool.split(t0, t1, 1, res.time_sec)
    assert sp["reads"] == t1["read_s"]["calls"]
    assert sp["plan_s"] == pytest.approx(
        t1["preprocess_s"]["total_s"] + t1["plan_s"]["total_s"])
    assert sp["rest_s"] == pytest.approx(
        sp["wall_s"] - sp["plan_s"] - sp["level_s"] - sp["read_s"])
