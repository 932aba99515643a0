"""The port's persistent ``twserved`` front end against the reference's:
the wire, in every pairing of client and server, plus shutdown drain,
eviction and payload coercion.

Twins of ``tests/test_twserved.py`` and of the wire case of
``tests/test_telemetry_scopes.py``.  Both packages speak one protocol
(newline-delimited JSON over TCP), so a reference client talks to the
port's server and the port's client to the reference server; a request
streams the same events and returns the same result either way
(``serve_twins``: only clocked fields are dropped).
"""
import dataclasses
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

from serve_twins import one_torch_thread, unclock  # noqa: F401
from repro.launch.twserved import TwServer as RefServer
from repro.serve.client import TwClient as RefClient
from repro.serve.client import TwServerError as RefServerError
from repro_torch.core import graph, solver
from repro_torch.launch.twserved import TwServer, _EventLog
from repro_torch.serve.client import TwClient, TwServerError

BLOCK = 32
POOL = dict(lanes=2, cap=1 << 12, block=BLOCK, m_bits=1 << 14)
PORT_POOL = dict(POOL, device="cpu")


@pytest.fixture()
def server():
    srv = TwServer(port=0, **PORT_POOL)
    srv.start()
    yield srv
    srv.close()


@pytest.fixture()
def ref_server():
    srv = RefServer(port=0, **POOL)
    srv.start()
    yield srv
    srv.close()


def _roundtrip(client, name="petersen", **knobs):
    rid = client.submit(name, **knobs)
    evs = [{k: v for k, v in e.items() if k != "ok"}
           for e in client.stream(rid)]
    res = client.result(rid)
    return unclock(evs), res, rid


# ------------------------------------------------------ clients x servers

@pytest.mark.parametrize("client_cls", [TwClient, RefClient],
                         ids=["port_client", "ref_client"])
def test_port_server_answers_either_client_as_the_reference(
        server, ref_server, client_cls):
    """The same submit through the port's server and through the
    reference server streams equal events and returns equal results."""
    c = client_cls(port=server.port)
    assert c.ping()
    got = _roundtrip(c)
    want = _roundtrip(client_cls(port=ref_server.port))
    assert got[:2] == want[:2]
    evs, res, rid = got
    assert evs[0]["event"] == "admitted" and evs[-1]["event"] == "done"
    ks = [e["k"] for e in evs if e["event"] == "rung_decided"]
    assert ks == sorted(ks) and ks
    assert (res["width"], res["exact"], res["expanded"]) == (4, True, 139)
    st = c.status(rid)
    assert st["state"] == "done" and st["width"] == 4
    assert [e["seq"] for e in c.stream(rid)] == [e["seq"] for e in evs]


def test_port_client_talks_to_the_reference_server(ref_server):
    c = TwClient(port=ref_server.port)
    g = graph.myciel(3)
    rid = c.submit(g, mode="bloom", speculate=2)    # a Graph on the wire
    res = c.result(rid)
    ref = solver.solve(g, cap=1 << 12, block=BLOCK, mode="bloom",
                       m_bits=1 << 14, device="cpu")
    assert (res["width"], res["exact"], res["expanded"]) == \
        (ref.width, ref.exact, ref.expanded)
    with pytest.raises(TwServerError, match="unknown graph"):
        c.submit("nope")


def test_submit_wire_graph_with_per_request_knobs(server, ref_server):
    g = graph.myciel(3)
    out = []
    for port in (server.port, ref_server.port):
        c = TwClient(port=port)
        res = c.result(c.submit(g, mode="bloom", speculate=2))
        res2 = c.result(c.submit(g, reconstruct=True))
        out.append((res, res2))
    assert out[0] == out[1]
    res, res2 = out[0]
    assert res2["order"] is not None
    assert solver.order_width(g, res2["order"]) == res2["width"]


def test_invalid_submits_fail_per_request_and_pool_survives(server):
    c = RefClient(port=server.port)          # the reference client's errors
    with pytest.raises(RefServerError, match="unknown graph"):
        c.submit("nope")
    with pytest.raises(RefServerError):
        c.submit("petersen", mode="nope")
    with pytest.raises(RefServerError, match="unknown rid"):
        c.result(999)
    assert c.result(c.submit("petersen"))["width"] == 4


def test_raw_json_lines_socket(server):
    with socket.create_connection(("127.0.0.1", server.port)) as s:
        s.sendall(b'{"op": "submit", "n": 4, "edges": '
                  b'[[0,1],[1,2],[2,3],[3,0]], "name": "c4"}\n')
        resp = json.loads(s.makefile("r").readline())
    assert resp["ok"]
    with socket.create_connection(("127.0.0.1", server.port)) as s:
        s.sendall(json.dumps({"op": "result",
                              "rid": resp["rid"]}).encode() + b"\n")
        res = json.loads(s.makefile("r").readline())
    assert res["ok"] and res["result"]["width"] == 2


# ------------------------------------------------- lifecycle and eviction

def test_result_eviction_bounds_server_memory():
    srv = TwServer(port=0, keep_results=2, **PORT_POOL)
    srv.start()
    try:
        c = TwClient(port=srv.port)
        rids = []
        for _ in range(4):
            rid = c.submit("myciel3")
            c.result(rid)
            rids.append(rid)
        deadline = time.time() + 10
        while time.time() < deadline and len(srv.sched.done) > 2:
            time.sleep(0.1)
        assert sorted(srv.sched.done) == rids[-2:]
        assert c.status(rids[0])["state"] == "unknown"
        with pytest.raises(TwServerError, match="unknown rid"):
            c.result(rids[0])
        assert c.status(rids[-1])["state"] == "done"
    finally:
        srv.close()


def test_shutdown_drains_and_exits():
    srv = TwServer(port=0, **PORT_POOL)
    srv.start()
    c = TwClient(port=srv.port)
    rid = c.submit("petersen")
    c.shutdown()
    srv._driver.join(timeout=120)
    assert not srv._driver.is_alive()
    assert rid in srv.sched.done
    assert srv.sched.done[rid].width == 4
    srv.close()


def test_eviction_skips_logs_with_blocked_readers():
    srv = TwServer(port=0, keep_results=1, **PORT_POOL)
    srv.start()
    try:
        c = TwClient(port=srv.port)
        slow = c.submit("queen6_6")
        got = {}

        def read_result():
            got["res"] = c.result(slow)

        t = threading.Thread(target=read_result)
        t.start()
        for _ in range(3):
            c.result(c.submit("myciel3"))
        t.join(timeout=120)
        assert not t.is_alive()
        ref = solver.solve(graph.queen(6), cap=1 << 12, block=BLOCK,
                           device="cpu")
        assert (got["res"]["width"], got["res"]["exact"]) == \
            (ref.width, ref.exact)
    finally:
        srv.close()


def test_evict_unit_semantics_unclosed_and_busy_logs_survive():
    srv = TwServer(port=0, keep_results=1, **PORT_POOL)
    try:
        sched = srv.sched
        for rid in (0, 1, 2):
            sched.terminal[rid] = "done"
            sched.done[rid] = object()
            log = _EventLog()
            log.push({"event": "done"})
            srv._logs[rid] = log
        srv._logs[1].acquire()
        srv._logs[2].closed = False
        srv._evict()
        assert 0 not in sched.done
        assert 1 in sched.done and 2 in sched.done
    finally:
        srv._tcp.server_close()


# --------------------------------------------- traffic shaping over the wire

def test_cancel_over_the_wire(server):
    c = TwClient(port=server.port)
    rid = c.submit("queen6_6")
    assert c.cancel(rid) is True
    assert c.cancel(rid) is False
    evs = list(c.stream(rid))
    assert evs[-1]["event"] == "cancelled"
    with pytest.raises(TwServerError, match="cancelled"):
        c.result(rid)
    assert c.status(rid)["state"] == "cancelled"
    assert c.result(c.submit("petersen"))["width"] == 4


def test_deadline_and_priority_knobs_ride_the_submit_line(server, ref_server):
    out = []
    for port in (server.port, ref_server.port):
        c = TwClient(port=port)
        res = c.result(c.submit("petersen", priority=1, deadline_s=3600.0))
        rid2 = c.submit("queen5_5", deadline_s=0.0)
        res2 = c.result(rid2)
        evs = unclock([{k: v for k, v in e.items() if k != "ok"}
                       for e in c.stream(rid2)])
        out.append((res, res2, evs))
    assert out[0] == out[1]
    res, res2, evs = out[0]
    assert (res["width"], res["exact"], res["expanded"]) == (4, True, 139)
    assert "timed_out" not in res
    assert res2["timed_out"] is True and res2["exact"] is False
    assert res2["lb"] <= res2["ub"] == res2["width"]
    assert evs[-1]["event"] == "done" and evs[-1]["timed_out"] is True


def test_backpressure_rejects_with_retry_after():
    srv = TwServer(port=0, max_queue=1, **PORT_POOL)
    acceptor = threading.Thread(target=srv._tcp.serve_forever, daemon=True)
    acceptor.start()
    try:
        c = TwClient(port=srv.port)
        c.submit("petersen")
        with pytest.raises(TwServerError, match="queue full") as ei:
            c.submit("myciel3")
        assert ei.value.retry_after is not None and ei.value.retry_after > 0
        with socket.create_connection(("127.0.0.1", srv.port)) as s:
            s.sendall(b'{"op": "submit", "graph": "myciel3"}\n')
            resp = json.loads(s.makefile("r").readline())
        assert resp["ok"] is False and resp["retry_after"] > 0
    finally:
        srv._tcp.shutdown()
        srv._tcp.server_close()


def test_server_never_passes_rids_so_they_never_collide(server):
    c = TwClient(port=server.port)
    rids = [c.submit("myciel3") for _ in range(3)]
    assert rids == sorted(set(rids))


@pytest.mark.parametrize("coerce", [
    lambda x: np.int64(x), lambda x: torch.tensor(x),
    lambda x: torch.tensor(x, dtype=torch.int32).reshape(()),
    lambda x: torch.tensor([x])[0]],
    ids=["numpy_scalar", "tensor_0d", "tensor_0d_int32", "tensor_item"])
def test_wire_responses_coerce_numpy_and_torch_payloads(coerce):
    """A result carrying numpy or torch scalars, 0-d tensors or arrays
    serializes instead of dying in ``json.dumps``."""
    srv = TwServer(port=0, **PORT_POOL)
    srv.start()
    try:
        c = TwClient(port=srv.port)
        rid = c.submit("petersen")
        res = c.result(rid)
        poisoned = dataclasses.replace(
            srv.sched.done[rid], width=coerce(res["width"]),
            order=torch.tensor([3, 1, 2]) if isinstance(coerce(0),
                                                        torch.Tensor)
            else np.array([3, 1, 2]),
            per_k={"g": {"expanded": coerce(7)}})
        srv.sched.done[rid] = poisoned
        res2 = c.result(rid)
        assert res2["width"] == res["width"]
        assert res2["order"] == [3, 1, 2]
        assert res2["per_k"]["g"]["expanded"] == 7
    finally:
        srv.close()


def test_metrics_op_over_the_wire():
    """The ``metrics`` op reconciles request scopes with the pool scope
    over the wire (rids stringify in JSON), on the port's server read by
    the reference client."""
    srv = TwServer(port=0, lanes=2, cap=1 << 12, block=BLOCK, device="cpu")
    srv.start()
    try:
        c = RefClient(port=srv.port)
        rid = c.submit("petersen")
        r_cancel = c.submit("myciel4", priority=-1)
        res = c.result(rid)
        c.cancel(r_cancel)
        m = c.metrics()
        pool = m["pool"]["counters"]
        for key in ("expanded", "rungs_decided", "rung_overflows"):
            total = sum(s["counters"].get(key, 0)
                        for s in m["requests"].values())
            assert total == pool.get(key, 0), (key, m)
        assert m["requests"][str(rid)]["counters"]["expanded"] == \
            res["expanded"]
        assert set(c.metrics(rid=rid)["requests"]) == {str(rid)}
    finally:
        c.shutdown()
        srv.serve_until_shutdown()


def test_cli_rejects_an_unported_pool_configuration(capsys):
    from repro_torch.launch import twserved
    assert twserved.main(["--port", "0", "--device", "cpu", "--schedule",
                          "while"]) == 2
    assert "unsupported pool configuration" in capsys.readouterr().err
