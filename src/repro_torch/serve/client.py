"""Client for the persistent treewidth solve service (``twserved``).

The service (``repro_torch.launch.twserved``) speaks newline-delimited JSON
over a plain TCP socket — one request object per line, one (or, for
``stream``, many) response object(s) per line back — so it is equally
scriptable from this module, from ``nc``/``curl --no-buffer
telnet://...``, or from any language with sockets and JSON.  This module
is a copy of ``repro.serve.client`` (sockets and JSON) over the port's
own ``graph``, so that the PyTorch port never imports ``repro``; the
wire is the same, so either package's client talks to either server.

Wire operations (see ``repro_torch.launch.twserved`` for the server side):

  {"op": "submit", "graph": "petersen", ...knobs}   -> {"ok": true, "rid": 0}
  {"op": "status", "rid": 0}                        -> {"ok": true, "state": ...}
  {"op": "stream", "rid": 0}    -> one event object per line, ending with a
                                   terminal event (done/cancelled/error)
  {"op": "result", "rid": 0}    -> blocks, then {"ok": true, "result": {...}}
  {"op": "cancel", "rid": 0}                        -> {"ok": true, "cancelled": true}
  {"op": "metrics"}             -> {"ok": true, "pool": {...}, "requests": {...}}
  {"op": "cache_stats"}         -> {"ok": true, "enabled": true, "hits": 3, ...}
  {"op": "shutdown"}                                -> {"ok": true}

Runnable example (start a server first, e.g.
``python -m repro_torch.launch.twserved --port 7421 --lanes 4 --block 32``)::

    from repro_torch.core import graph
    from repro_torch.serve.client import TwClient

    c = TwClient(port=7421)
    rid = c.submit("petersen")                  # by registry name
    rid2 = c.submit(graph.myciel(3), use_mmw=True)   # or a Graph + knobs
    for ev in c.stream(rid):                    # anytime lb/ub rung events
        print(ev["event"], ev.get("k"), ev.get("lb"), ev.get("ub"))
    print(c.result(rid)["width"])
    c.shutdown()

Per-request knobs (``mode``, ``use_mmw``, ``use_simplicial``, ``cap``,
``speculate``, ``shards`` — intra-request scale-out across that many
pool slots — ``reconstruct``, ``start_k``, and the traffic-shaping
pair ``priority``/``deadline_s``) ride through ``submit`` to
``TwScheduler.submit`` — an override the pool's backend cannot run fails
that submit alone with ``TwServerError`` (the scheduler's per-request
``BackendCapabilityError`` surfaced over the wire).  When the server's
admission queue is bounded (``--max-queue``) an over-limit submit raises
``TwServerError`` with ``retry_after`` set — back off that many seconds
and resubmit.  A timed-out request's result carries ``exact: false`` and
``timed_out: true`` with its monotone anytime lb/ub; ``cancel`` ends a
request early (its stream terminates with the ``cancelled`` event and
``result`` raises).
"""
from __future__ import annotations

import json
import socket
from typing import Iterator, Optional, Union

from repro_torch.core.graph import Graph

DEFAULT_PORT = 7421


class TwServerError(RuntimeError):
    """The server answered {"ok": false} — message carries its error.

    ``retry_after`` (seconds, else ``None``) is set when the rejection
    was backpressure: the server's admission queue was at its bound and
    the hint estimates when a slot frees up.
    """

    def __init__(self, msg: str, retry_after: Optional[float] = None):
        super().__init__(msg)
        self.retry_after = retry_after


def graph_to_wire(g: Graph) -> dict:
    """Serialise a ``Graph`` as the wire's {n, edges, name} triple."""
    edges = [[int(u), int(v)] for u in range(g.n) for v in range(u + 1, g.n)
             if g.adj[u][v]]
    return {"n": int(g.n), "edges": edges, "name": g.name}


class TwClient:
    """Thin blocking client: one TCP connection per operation (the
    protocol is stateless per line; ``stream`` holds its connection open
    until the ``done`` event arrives)."""

    def __init__(self, host: str = "127.0.0.1", port: int = DEFAULT_PORT,
                 timeout: Optional[float] = 60.0):
        """``timeout`` covers connecting and the quick operations
        (submit/status/ping/shutdown).  ``result`` and ``stream`` are
        *documented to block* for as long as the solve runs, so they
        read without a deadline by default — pass ``read_timeout`` to
        them to bound the wait."""
        self.host = host
        self.port = port
        self.timeout = timeout

    def _request(self, obj: dict, read_timeout: Optional[float] = -1.0):
        """Open, send one JSON line, yield response lines, close.
        ``read_timeout=-1`` keeps the connect timeout for reads."""
        with socket.create_connection((self.host, self.port),
                                      timeout=self.timeout) as sock:
            sock.sendall((json.dumps(obj) + "\n").encode())
            if read_timeout is None or read_timeout >= 0:
                sock.settimeout(read_timeout)
            with sock.makefile("r", encoding="utf-8") as rf:
                for line in rf:
                    line = line.strip()
                    if line:
                        yield json.loads(line)

    def _rpc(self, obj: dict, read_timeout: Optional[float] = -1.0) -> dict:
        for resp in self._request(obj, read_timeout):
            if not resp.get("ok", False):
                raise TwServerError(resp.get("error", "unknown error"),
                                    retry_after=resp.get("retry_after"))
            return resp
        raise TwServerError("connection closed without a response")

    # ------------------------------------------------------------- surface

    def submit(self, g: Union[Graph, str], **knobs) -> int:
        """Submit one solve request; returns its rid.  ``g`` is a
        ``Graph`` or a ``core.graph.REGISTRY`` generator name; ``knobs``
        are the per-request overrides (``reconstruct``, ``start_k``,
        ``mode``, ``use_mmw``, ``use_simplicial``, ``cap``,
        ``speculate``, ``shards``, ``priority``, ``deadline_s``,
        ``heuristics``, ``heuristic_only``, ``seed``, ``no_cache``).
        ``heuristic_only=True`` serves anytime bounds without any exact
        rung — graphs beyond exact-DP reach terminate with
        ``exact = (lb == ub)``; ``heuristics`` budgets the improver
        rounds and ``seed`` pins their draws.  Raises ``TwServerError``
        with ``retry_after`` set when the server shed the submit under
        backpressure."""
        req = {"op": "submit", **knobs}
        if isinstance(g, str):
            req["graph"] = g
        else:
            req.update(graph_to_wire(g))
        return int(self._rpc(req)["rid"])

    def status(self, rid: int) -> dict:
        """Queued / running (with running lb/ub) / terminal snapshot
        (``done`` — possibly ``timed_out`` — / ``cancelled`` /
        ``error``)."""
        return self._rpc({"op": "status", "rid": rid})

    def cancel(self, rid: int) -> bool:
        """Abandon a queued or running request (frees its lane
        mid-ladder).  True if something was cancelled; False for
        unknown or already-terminal rids (idempotent)."""
        return bool(self._rpc({"op": "cancel", "rid": rid})["cancelled"])

    def result(self, rid: int,
               read_timeout: Optional[float] = None) -> dict:
        """Block until the request finishes (no read deadline unless
        ``read_timeout`` is given); returns the result dict (width,
        exact, lb, ub, expanded, order, per_k; deadline-preempted
        requests additionally carry ``timed_out: true`` and their
        anytime bounds).  Raises ``TwServerError`` for a cancelled or
        admission-failed rid."""
        return self._rpc({"op": "result", "rid": rid},
                         read_timeout)["result"]

    def stream(self, rid: int,
               read_timeout: Optional[float] = None) -> Iterator[dict]:
        """Yield the request's event stream — ``admitted``/``bounds``,
        then per-rung ``rung_started``/``rung_decided`` with running
        monotone lb/ub, then the terminal event (``done`` — flagged
        ``timed_out`` for a deadline preemption — ``cancelled`` or
        ``error``; always last, iteration stops there).  Replays from
        the first event, so streaming a finished request yields its full
        history.  Blocks between events without a read deadline unless
        ``read_timeout`` bounds the gap."""
        for ev in self._request({"op": "stream", "rid": rid},
                                read_timeout):
            if not ev.get("ok", True):
                raise TwServerError(ev.get("error", "unknown error"))
            yield ev
            if ev.get("event") in ("done", "cancelled", "error"):
                return

    def metrics(self, rid: Optional[int] = None) -> dict:
        """The server's scoped telemetry snapshot
        (``TwScheduler.metrics``): ``pool`` carries the pool scope's
        counters/gauges/timings, ``requests`` maps rid -> that request's
        child-scope snapshot (live requests as of now, finished ones as
        frozen at their terminal event).  ``rid`` filters ``requests``
        to one request."""
        req = {"op": "metrics"}
        if rid is not None:
            req["rid"] = int(rid)
        resp = self._rpc(req)
        resp.pop("ok", None)
        return resp

    def cache_stats(self) -> dict:
        """The server's result-cache counters (``TwScheduler.
        cache_stats``): ``enabled`` plus, when a cache is configured,
        entries/capacity/pinned and the hits/misses/insertions/evictions
        counters with the running ``hit_rate``.  A cached submit's
        events and its ``admitted`` line carry ``"cached": true``; the
        ``no_cache`` submit knob bypasses the cache per request."""
        resp = self._rpc({"op": "cache_stats"})
        resp.pop("ok", None)
        return resp

    def ping(self) -> bool:
        try:
            return bool(self._rpc({"op": "ping"})["ok"])
        except OSError:
            return False

    def shutdown(self) -> None:
        """Ask the server process to drain in-flight work and exit."""
        self._rpc({"op": "shutdown"})
