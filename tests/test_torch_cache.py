"""The port's content-addressed result cache against the reference's: the
LRU+pin policy, warm hits under the scheduler, and negative caching.

Twins of ``tests/test_cache.py``.  The policy cases run the same script
on both packages' ``ResultCache`` and compare what each returned.  The
scheduler cases run through both ``TwScheduler``s (``serve_twins``: equal
result surfaces and event streams; only clocked fields are dropped): a
warm hit is bit-identical to its cold solve and launches nothing, an
isomorphic relabeling gets an order valid for its own labels, Bloom hits
identical bytes only, and cancel, timeout and admission errors are never
inserted.
"""
import numpy as np
import pytest

import oracle
from serve_twins import (Events, PORT, REF, one_torch_thread, record, sched,
                         surface, twin)  # noqa: F401
from repro_torch.core import graph
from repro_torch.launch.twserved import TwServer
from repro_torch.serve import twscheduler
from repro_torch.serve.cache import ResultCache
from repro_torch.serve.client import TwClient

BLOCK = 32
FAST = dict(cap=1 << 12, block=BLOCK)
GOLDEN = oracle.golden_cases()
GFAST = dict(cap=1 << 16, block=1 << 9)


def _res(pkg, width=3, order=None, per_k=None, expanded=10):
    return pkg.solver.SolveResult(width=width, exact=True, lb=width,
                                  ub=width, expanded=expanded, time_sec=0.0,
                                  order=order, per_k=per_k)


# --------------------------------------------------------- LRU+pin policy

def _policy_trace(pkg):
    out = []
    c = pkg.ResultCache(entries=2)
    c.insert("a", _res(pkg, 1)); c.insert("b", _res(pkg, 2))
    out.append(c.lookup("a").width)
    out.append(c.insert("c", _res(pkg, 3)))
    out.append(("b" in c, "a" in c, "c" in c, len(c)))
    c = pkg.ResultCache(entries=1)
    c.insert("a", _res(pkg, 1))
    out.append((c.pin("a"), c.pin("ghost")))
    out.append((c.insert("b", _res(pkg, 2)), len(c),
                c.stats()["pinned"]))
    out.append((c.unpin("a"), c.insert("d", _res(pkg, 4)), len(c),
                 "d" in c))
    c = pkg.ResultCache(entries=4)
    c.insert("k", _res(pkg, 3))
    out.append((c.lookup("k", need_order=True), c.lookup("k").order))
    c.insert("k", _res(pkg, 3, order=[2, 0, 1]))
    out.append(c.lookup("k", need_order=True).order)
    c.insert("k", _res(pkg, 3))
    out.append(c.peek("k").order)
    c = pkg.ResultCache(entries=2)
    c.insert("k", _res(pkg, 3, order=[0, 1, 2], per_k={"b": {"f": 1}}))
    r = c.lookup("k")
    r.order.append(99); r.per_k["x"] = 1
    clean = c.peek("k")
    out.append((clean.order, sorted(clean.per_k)))
    with pytest.raises(ValueError):
        pkg.ResultCache(entries=0)
    c = pkg.ResultCache(entries=2)
    c.insert("a", _res(pkg, 1))
    c.lookup("a"); c.lookup("a"); c.lookup("nope")
    out.append(c.stats())
    return out


def test_lru_pin_upgrade_copy_and_stats_policy():
    got = _policy_trace(PORT)
    assert got == _policy_trace(REF)
    assert got[0] == 1 and got[1] == 1
    assert got[2] == (False, True, True, 2)
    assert got[3] == (True, False) and got[4] == (0, 2, 1)
    assert got[5] == (True, 2, 1, True)
    assert got[6] == (None, None) and got[7] == got[8] == [2, 0, 1]
    assert got[9] == ([0, 1, 2], ["b"])
    s = got[10]
    assert s["hits"] == 2 and s["misses"] == 1 and s["entries"] == 1
    assert s["insertions"] - s["evictions"] == s["entries"]
    assert s["hit_rate"] == pytest.approx(2 / 3)


# ---------------------------------------------- golden differential parity

@pytest.mark.parametrize("name,gf,want", GOLDEN,
                         ids=[n for n, _, _ in GOLDEN])
def test_golden_warm_hit_is_bit_identical_and_dispatch_free(
        name, gf, want, event_invariants):
    g0 = gf()

    def scenario(pkg):
        g = pkg.graph.Graph(g0.n, g0.adj.copy(), g0.name)
        s = sched(pkg, lanes=2, cache=pkg.ResultCache(32), **GFAST)
        ev = Events()
        r0 = s.submit(g, on_event=ev)
        s.run()
        pkg.engine.reset_counters()
        r1 = s.submit(g, on_event=ev)
        terminal_at_submit = s.terminal[r1]
        s.run()
        rec = record(s, [r0, r1], ev)
        rec.update(terminal_at_submit=terminal_at_submit,
                   stats=s.cache_stats(),
                   warm_work=(dict(pkg.engine.COUNTERS).get("dispatches", 0),
                              dict(pkg.engine.COUNTERS).get("expanded", 0)))
        return rec

    _ref, port = twin(scenario)
    cold, warm = port["results"][0], port["results"][1]
    assert cold[1] and cold[0] == want
    assert warm == cold
    assert port["terminal_at_submit"] == "done"
    assert port["warm_work"] == (0, 0)
    assert event_invariants(port["events"][0], rid=0)["event"] == "done"
    assert event_invariants(port["events"][1], rid=1)["event"] == "done"
    assert not port["events"][0][0].get("cached")
    assert all(e.get("cached") for e in port["events"][1])
    s = port["stats"]
    assert s["enabled"] and s["hits"] == 1 and s["insertions"] == 1


@pytest.mark.parametrize("ref_backend,mode,shards",
                         [("jax", "sort", 1), ("jax", "bloom", 1),
                          ("jax", "sort", 2), ("pallas", "sort", 1)])
def test_warm_parity_across_backend_mode_shards(ref_backend, mode, shards):
    """The reference on each of its backends against the port's ``torch``
    ops (the keys name each package's own backend; the results agree)."""
    def scenario(pkg):
        gs = [pkg.graph.petersen(), pkg.graph.myciel(3)]
        kw = dict(cap=1 << 12, block=BLOCK, mode=mode, m_bits=1 << 14,
                  schedule="doubling",
                  backend=ref_backend if pkg is REF else "torch")
        s = sched(pkg, lanes=2, cache=pkg.ResultCache(16), **kw)
        ev = Events()
        cold = [s.submit(g, shards=shards, on_event=ev) for g in gs]
        s.run()
        warm = [s.submit(g, shards=shards, on_event=ev) for g in gs]
        s.run()
        rec = record(s, cold + warm, ev)
        rec["hits"] = s.cache_stats()["hits"]
        return rec

    _ref, port = twin(scenario)
    res = port["results"]
    assert (res[0], res[1]) == (res[2], res[3])
    assert port["hits"] == 2


def test_shards_do_not_split_the_key():
    def scenario(pkg):
        s = sched(pkg, lanes=2, cache=pkg.ResultCache(8), **FAST)
        r0 = s.submit(pkg.graph.petersen())
        s.run()
        r1 = s.submit(pkg.graph.petersen(), shards=2)
        at_submit = s.terminal[r1]
        s.run()
        rec = record(s, [r0, r1])
        rec["at_submit"] = at_submit
        return rec

    _ref, port = twin(scenario)
    assert port["at_submit"] == "done"
    assert port["results"][0] == port["results"][1]


def test_iso_relabeled_hit_returns_a_valid_translated_order():
    def scenario(pkg):
        g = pkg.graph.petersen()
        h = g.relabel(np.random.RandomState(9).permutation(g.n))
        s = sched(pkg, lanes=2, cache=pkg.ResultCache(8), **FAST)
        r0 = s.submit(g, reconstruct=True)
        s.run()
        r1 = s.submit(h, reconstruct=True)
        at_submit = s.terminal[r1]
        s.run()
        rec = record(s, [r0, r1])
        rec.update(at_submit=at_submit,
                   widths=[pkg.solver.order_width(g, s.done[r0].order),
                           pkg.solver.order_width(h, s.done[r1].order)])
        return rec

    _ref, port = twin(scenario)
    cold, warm = port["results"][0], port["results"][1]
    assert port["at_submit"] == "done"
    assert warm[:2] == cold[:2] and warm[1]
    assert sorted(warm[6]) == list(range(10))
    assert port["widths"] == [cold[0], cold[0]]


def test_reconstruct_miss_upgrades_the_entry():
    def scenario(pkg):
        g = pkg.graph.petersen()
        s = sched(pkg, lanes=2, cache=pkg.ResultCache(8), **FAST)
        r0 = s.submit(g)
        s.run()
        r1 = s.submit(g, reconstruct=True)
        states = [s.terminal.get(r1)]
        s.run()
        r2 = s.submit(g, reconstruct=True)
        states.append(s.terminal[r2])
        s.run()
        rec = record(s, [r0, r1, r2])
        rec["states"] = states
        rec["width"] = pkg.solver.order_width(g, s.done[r1].order)
        return rec

    _ref, port = twin(scenario)
    assert port["states"] == [None, "done"]
    assert port["width"] == port["results"][1][0]
    assert port["results"][2][6] == port["results"][1][6]


def test_bloom_hits_identical_bytes_only():
    def scenario(pkg):
        g = pkg.graph.petersen()
        h = g.relabel(np.random.RandomState(3).permutation(g.n))
        s = sched(pkg, lanes=2, cache=pkg.ResultCache(8), block=BLOCK,
                  cap=1 << 12, mode="bloom", m_bits=1 << 14)
        r0 = s.submit(g)
        s.run()
        r1 = s.submit(g)
        r2 = s.submit(h)
        states = [s.terminal.get(r1), s.terminal.get(r2)]
        s.run()
        rec = record(s, [r0, r1, r2])
        rec.update(states=states,
                   insertions=s.cache_stats()["insertions"])
        return rec

    _ref, port = twin(scenario)
    assert port["states"] == ["done", None]
    assert port["results"][2][0] == port["results"][0][0]
    assert port["insertions"] == 2


# ------------------------------------------------------- negative caching

def test_cancel_timeout_and_error_are_never_inserted(monkeypatch):
    def scenario(pkg):
        out = {}
        cache = pkg.ResultCache(8)
        s = sched(pkg, lanes=1, cache=cache, **FAST)
        rid = s.submit(pkg.graph.queen(5))
        assert s.cancel(rid)
        s.run()
        out["cancel"] = (len(cache), cache.stats()["insertions"])
        cache = pkg.ResultCache(8)
        s = sched(pkg, lanes=1, cache=cache, **FAST)
        r0 = s.submit(pkg.graph.queen(5), deadline_s=0.0)
        s.run()
        out["timeout"] = (s.terminal[r0], len(cache),
                          cache.stats()["insertions"])
        r1 = s.submit(pkg.graph.queen(5))
        out["after_timeout"] = s.terminal.get(r1)
        s.run()
        out["rec"] = record(s, [r0, r1])
        return out

    _ref, port = twin(scenario)
    assert port["cancel"] == (0, 0)
    assert port["timeout"] == ("timeout", 0, 0)
    assert port["after_timeout"] is None
    assert not port["rec"]["results"][0][1] and port["rec"]["results"][1][1]

    cache = ResultCache(8)
    s = sched(PORT, lanes=1, cache=cache, **FAST)

    def boom(*a, **kw):
        raise RuntimeError("admission blew up")

    monkeypatch.setattr(twscheduler.batch, "InstanceState", boom)
    rid = s.submit(graph.petersen())
    s.run()
    assert s.terminal[rid] == "error"
    assert len(cache) == 0 and cache.stats()["insertions"] == 0


def test_no_cache_and_heuristic_only_bypass_the_cache():
    def scenario(pkg):
        cache = pkg.ResultCache(8)
        s = sched(pkg, lanes=1, cache=cache, **FAST)
        g = pkg.graph.petersen()
        r0 = s.submit(g, no_cache=True)
        s.run()
        sizes = [len(cache)]
        r1 = s.submit(g)
        s.run()
        r2 = s.submit(g, no_cache=True)
        states = [s.terminal.get(r2)]
        s.run()
        r3 = s.submit(g, heuristic_only=True, seed=1)
        s.run()
        rec = record(s, [r0, r1, r2, r3])
        rec.update(sizes=sizes, states=states, stats=cache.stats())
        return rec

    _ref, port = twin(scenario)
    res = port["results"]
    assert port["sizes"] == [0] and port["states"] == [None]
    assert res[0] == res[1] == res[2]
    assert res[3] is not None
    s = port["stats"]
    assert s["hits"] == 0 and s["insertions"] == 1 and s["misses"] == 1


# --------------------------------------------------- telemetry + the wire

def test_cache_counters_reconcile_with_cache_stats():
    def scenario(pkg):
        cache = pkg.ResultCache(2)
        s = sched(pkg, lanes=2, cache=cache, tracker=pkg.Tracker(), **FAST)
        g = pkg.graph
        gs = [g.petersen(), g.myciel(3), g.grid(3, 4), g.petersen()]
        rids = [s.submit(x) for x in gs]
        s.run()
        rids += [s.submit(x) for x in gs[:2]]
        s.run()
        pool = s.metrics()["pool"]["counters"]
        rec = record(s, rids)
        rec.update(stats=cache.stats(),
                   counters={k: pool.get(f"cache_{k}", 0)
                             for k in ("hits", "misses", "insertions",
                                       "evictions")})
        return rec

    _ref, port = twin(scenario)
    for k, v in port["counters"].items():
        assert v == port["stats"][k], k
    assert port["stats"]["evictions"] > 0


def test_cache_over_the_wire():
    srv = TwServer(port=0, lanes=2, cap=1 << 12, block=BLOCK,
                   m_bits=1 << 14, cache=8, device="cpu")
    srv.start()
    try:
        c = TwClient(port=srv.port)
        cold = c.result(c.submit("petersen"))
        s0 = c.cache_stats()
        assert s0["enabled"] and s0["insertions"] == 1
        rid2 = c.submit("petersen")
        evs = list(c.stream(rid2))
        assert evs and all(e.get("cached") for e in evs)
        warm = c.result(rid2)
        for f in ("width", "exact", "lb", "ub", "expanded", "per_k"):
            assert warm[f] == cold[f], f
        assert c.cache_stats()["hits"] == 1
        bypass = c.result(c.submit("petersen", no_cache=True))
        assert bypass["width"] == cold["width"]
        s = c.cache_stats()
        assert s["hits"] == 1 and s["insertions"] == 1
    finally:
        srv.close()


def test_cacheless_scheduler_reports_disabled():
    s = sched(PORT, lanes=1, **FAST)
    assert s.cache_stats() == {"enabled": False}
    rid = s.submit(graph.petersen())
    assert s.terminal.get(rid) != "done"
    assert surface(s.run()[rid])[:2] == (4, True)
