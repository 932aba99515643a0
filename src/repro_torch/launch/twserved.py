"""Persistent treewidth solve service: a long-lived socket front end over
the async scheduler, in the PyTorch port.

A port of ``repro.launch.twserved`` with the same wire, ops and flags
(``--backend`` is ``torch``/``cuda``, and ``--device`` is added, as in
``repro_torch.launch.solve``): a reference client talks to this server
and this package's client to the reference server.  The pool runs on the
card unless ``--device cpu`` asks for the CPU.  The port's dispatches run
their whole rung before they return, so ``--pipeline`` overlap and a
``cancel`` of a running request act at rung boundaries.  The reference's
notes follow.

``twserve`` (the sibling CLI) drains one request stream and exits;
``twserved`` is the serving rung the ROADMAP asked for — a process that
stays up, admits requests *while dispatches are in flight* (the
scheduler's launch/sync overlap, DESIGN.md §11), and streams per-rung
anytime lb/ub verdicts to clients before the final width is decided.

    python -m repro_torch.launch.twserved --port 7421 --lanes 4 --block 32
    python -m repro_torch.launch.twserved --device cpu

Protocol: newline-delimited JSON over TCP (scriptable from ``nc``; see
``repro_torch.serve.client`` for the client).  One request object
per line:

    {"op": "submit", "graph": "petersen"}            -> {"ok": true, "rid": 0}
    {"op": "submit", "n": 4, "edges": [[0,1],[1,2],[2,3]],
     "mode": "bloom", "speculate": 2}                -> {"ok": true, "rid": 1}
    {"op": "submit", "graph": "queen5", "priority": 1,
     "deadline_s": 2.5}                              -> {"ok": true, "rid": 2}
    {"op": "submit", "graph": "queen5", "shards": 4} -> {"ok": true, "rid": 3}
    {"op": "status", "rid": 0}   -> {"ok": true, "state": "running", "lb": 2, "ub": 4}
    {"op": "stream", "rid": 0}   -> one event per line, ends with a terminal
                                    event ({"event": "done" | "cancelled" | "error"})
    {"op": "result", "rid": 0}   -> blocks -> {"ok": true, "result": {"width": ...}}
    {"op": "cancel", "rid": 0}   -> {"ok": true, "cancelled": true}
    {"op": "metrics"}            -> {"ok": true, "pool": {...}, "requests": {...}}
    {"op": "metrics", "rid": 0}  -> same, "requests" filtered to rid 0
    {"op": "cache_stats"}        -> {"ok": true, "enabled": true, "hits": 3, ...}
    {"op": "shutdown"}           -> {"ok": true}  (drains in-flight, exits)

Result cache (DESIGN.md §16): the server keeps a content-addressed
cache of finished solves keyed on the *canonical* graph form × the
effective config (``--cache N`` entries, LRU; 0 disables).  A repeat
submission — even an isomorphically relabeled one — resolves at submit
time with a synthesized event stream flagged ``"cached": true`` and
never touches the queue or the device; ``"no_cache": true`` on a submit
line forces a fresh solve and suppresses insertion.  ``cache_stats``
returns the hit/miss/eviction counters.

``metrics`` returns the scheduler's scoped telemetry snapshot
(``TwScheduler.metrics``): pool-level counters/gauges/timings plus the
per-request child scopes — live requests snapshotted in place, finished
ones as frozen at their terminal event.  A request's timings hold its
queue wait (``admission_s``) apart from its planning (the
``preprocess_s`` and ``plan_s`` spans), both rolled up into the pool.
``--metrics-jsonl PATH`` additionally streams every telemetry record (one
JSON line each) to a file for offline analysis.

Traffic shaping (DESIGN.md §12): ``--max-queue`` bounds the admission
queue — an over-limit submit is *rejected*, not queued::

    {"ok": false, "error": "admission queue full ...", "retry_after": 1.5}

``priority`` (higher = more urgent, weighted FIFO — the base class is
never starved) and ``deadline_s`` (seconds; past it the request is
preempted and resolves with its monotone anytime lb/ub, ``exact`` false,
``timed_out`` true) ride the submit line like any other knob;
``--pipeline 2`` keeps a second dispatch round in flight so the device
stays busy across each host sync.

Anytime bounds engine (DESIGN.md §15): ``heuristics`` budgets the
improver rounds interleaved with a request's exact rungs (``bounds``
events stream every movement), ``heuristic_only: true`` serves bounds
without any exact rung — graphs beyond exact-DP reach terminate with
``exact = (lb == ub)`` — and ``seed`` pins the heuristic draws::

    {"op": "submit", "graph": "mcgee", "heuristic_only": true,
     "heuristics": 8, "seed": 7}                     -> {"ok": true, "rid": 4}

Architecture: one **driver thread** owns all device work (every kernel
launches on that thread's current CUDA stream) and steps the
scheduler (``launch`` → ``poll_admissions`` → ``sync``); socket threads
(one per connection, stdlib ``socketserver``) only call the scheduler's
thread-safe ``submit``/``status`` surface and read per-request event
queues — so a submission landing during a device dispatch is admitted
mid-flight and packed into the next one.  A per-request override the
backend cannot run fails that submit alone ({"ok": false, "error":
"..."}); the pool keeps serving.
"""
from __future__ import annotations

import argparse
import json
import socketserver
import sys
import threading
import traceback
from typing import Callable, Dict, Optional

DEFAULT_PORT = 7421

# finished requests retained for status/result/stream replay before the
# oldest are evicted (bounds a long-lived server's memory)
DEFAULT_KEEP_RESULTS = 1024


# event names that end a request's stream (mirrors the scheduler's
# terminal model: done covers deadline expiry via ``timed_out``)
_TERMINAL_EVENTS = ("done", "cancelled", "error")


class _EventLog:
    """Append-only per-request event history with blocking iteration —
    the bridge between the driver thread (producer) and any number of
    ``stream``/``result`` connections (consumers, each replaying from
    the start).  ``closed`` flips when the terminal event lands;
    ``readers`` counts registered consumers — eviction must skip a log
    that is unclosed or still being read (``TwServer._evict``), or a
    blocked reader would see a finished solve vanish under it."""

    def __init__(self):
        self.events = []
        self.cond = threading.Condition()
        self.readers = 0
        self.closed = False

    def push(self, ev: dict) -> None:
        with self.cond:
            self.events.append(ev)
            if ev.get("event") in _TERMINAL_EVENTS:
                self.closed = True
            self.cond.notify_all()

    def acquire(self) -> None:
        with self.cond:
            self.readers += 1

    def release(self) -> None:
        with self.cond:
            self.readers -= 1

    @property
    def busy(self) -> bool:
        with self.cond:
            return self.readers > 0

    def iter_events(self, stopped: Callable[[], bool]):
        """Yield events in order until the terminal one; ``stopped()`` is
        the give-up probe — during a shutdown *drain* it must stay False
        so blocked consumers still receive the results of admitted
        work."""
        i = 0
        while True:
            with self.cond:
                while i >= len(self.events):
                    if stopped():
                        return
                    self.cond.wait(timeout=0.2)
            ev = self.events[i]
            i += 1
            yield ev
            if ev.get("event") in _TERMINAL_EVENTS:
                return


def _wire_to_graph(msg: dict):
    from repro_torch.core import graph as graph_lib

    if "graph" in msg:
        name = msg["graph"]
        if name not in graph_lib.REGISTRY:
            raise ValueError(f"unknown graph {name!r}; known: "
                             f"{sorted(graph_lib.REGISTRY)}")
        return graph_lib.REGISTRY[name]()
    if "n" in msg:
        return graph_lib.from_edges(int(msg["n"]), msg.get("edges", []),
                                    name=msg.get("name", "wire"))
    raise ValueError('submit needs "graph": <registry name> or '
                     '"n" + "edges"')


_KNOBS = ("reconstruct", "start_k", "mode", "use_mmw", "use_simplicial",
          "cap", "speculate", "shards", "priority", "deadline_s",
          "heuristics", "heuristic_only", "seed", "no_cache")


class TwServer:
    """The persistent service: scheduler + driver thread + TCP front end.

    Built separately from ``main`` so tests can run it in-process::

        srv = TwServer(port=0, lanes=2, block=32)   # port 0: ephemeral
        srv.start()
        ... TwClient(port=srv.port) ...
        srv.close()
    """

    def __init__(self, *, host: str = "127.0.0.1", port: int = DEFAULT_PORT,
                 keep_results: int = DEFAULT_KEEP_RESULTS,
                 metrics_jsonl=None, **sched_kw):
        from repro_torch.core import telemetry
        from repro_torch.serve.twscheduler import TwScheduler

        self.sched = TwScheduler(**sched_kw)
        self._metrics_sink = None
        if metrics_jsonl is not None:
            # stream every telemetry record of this pool's scope tree
            # (pool + per-request children) as JSON lines
            self._metrics_sink = telemetry.JsonlSink(metrics_jsonl)
            self.sched.tracker.add_sink(self._metrics_sink)
        self.keep_results = max(1, int(keep_results))
        self._logs: Dict[int, _EventLog] = {}
        self._logs_lock = threading.Lock()   # _logs map + eviction vs readers
        self._stop = threading.Event()
        self._wake = threading.Condition()
        self._driver: Optional[threading.Thread] = None

        outer = self

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                line = self.rfile.readline()
                if not line:
                    return
                try:
                    msg = json.loads(line)
                    outer._handle(msg, self.wfile)
                except Exception as e:      # noqa: BLE001 — wire boundary
                    _send(self.wfile, {"ok": False, "error": str(e)})

        class _TCP(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._tcp = _TCP((host, port), _Handler)
        self.host, self.port = self._tcp.server_address[:2]

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        """Spawn the driver and acceptor threads; returns immediately."""
        self._driver = threading.Thread(target=self._drive,
                                        name="twserved-driver", daemon=True)
        self._driver.start()
        self._acceptor = threading.Thread(target=self._tcp.serve_forever,
                                          name="twserved-accept",
                                          daemon=True)
        self._acceptor.start()

    def close(self) -> None:
        """Stop accepting, drain the driver, release the socket."""
        self._stop.set()
        with self._wake:
            self._wake.notify_all()
        self._tcp.shutdown()
        self._tcp.server_close()
        if self._driver is not None:
            self._driver.join(timeout=30)
        if self._metrics_sink is not None:
            self._metrics_sink.close()

    def serve_until_shutdown(self) -> None:
        """Block the calling thread until a shutdown request arrives."""
        self._stop.wait()
        self.close()

    # --------------------------------------------------------------- driver

    def _drive(self):
        """The one thread that owns the device: overlapped scheduler steps while
        busy, condition-wait while idle.  A raising step must never kill
        the only thread that advances the pool — it is logged, the
        scheduler recovers its in-flight state, and driving resumes."""
        while not self._stop.is_set():
            try:
                stepped = self.sched.step()
                self._evict()
            except Exception:        # noqa: BLE001 — keep the pool alive
                traceback.print_exc()
                self.sched.recover()
                self._stop.wait(timeout=0.5)    # never a hot error loop
                continue
            if not stepped:
                with self._wake:
                    self._wake.wait(timeout=0.2)
        # drain: finish what was admitted before the shutdown request
        try:
            self.sched.run()
        except Exception:            # noqa: BLE001
            traceback.print_exc()
            self.sched.recover()

    def _evict(self):
        """Bound a long-lived server's memory: keep only the newest
        ``keep_results`` *terminal* requests' results/event logs (evicted
        rids answer ``status``/``result``/``stream`` as unknown).  A log
        that is not yet closed (its terminal event has not been
        delivered) or that a blocked ``stream``/``result`` reader is
        still draining is skipped this pass — evicting it would turn a
        finished solve into a bogus "server shut down" error for that
        reader."""
        sched = self.sched
        with self._logs_lock:
            term = sched.terminal
            if len(term) <= self.keep_results:
                return
            for rid in sorted(term)[:len(term) - self.keep_results]:
                log = self._logs.get(rid)
                if log is not None and (log.busy or not log.closed):
                    continue
                term.pop(rid, None)
                sched.done.pop(rid, None)
                sched.errors.pop(rid, None)
                sched.req_metrics.pop(rid, None)
                self._logs.pop(rid, None)

    def _reader(self, rid: int) -> _EventLog:
        """Look up a request's event log and register as a reader in one
        atomic step (vs ``_evict``), so the log cannot be evicted between
        the lookup and the registration."""
        with self._logs_lock:
            log = self._logs.get(rid)
            if log is None:
                raise ValueError(f"unknown rid {rid}")
            log.acquire()
        return log

    def _stopped_and_drained(self) -> bool:
        """The give-up probe for blocked stream/result consumers: only
        after the shutdown drain finished can a missing done event never
        arrive."""
        return self._stop.is_set() and not (
            self._driver is not None and self._driver.is_alive())

    # ------------------------------------------------------------- protocol

    def _handle(self, msg: dict, wfile):
        op = msg.get("op")
        if op == "ping":
            _send(wfile, {"ok": True})
        elif op == "submit":
            if self._stop.is_set():
                raise RuntimeError("server is shutting down")
            from repro_torch.serve.slots import QueueFull

            g = _wire_to_graph(msg)
            knobs = {k: msg[k] for k in _KNOBS if msg.get(k) is not None}
            log = _EventLog()
            try:
                rid = self.sched.submit(g, on_event=log.push, **knobs)
            except QueueFull as e:        # backpressure: shed with a hint
                _send(wfile, {"ok": False, "error": str(e),
                              "retry_after": e.retry_after})
                return
            with self._logs_lock:
                self._logs[rid] = log
            with self._wake:
                self._wake.notify_all()
            _send(wfile, {"ok": True, "rid": rid})
        elif op == "status":
            _send(wfile, {"ok": True, **self.sched.status(_rid(msg))})
        elif op == "metrics":
            rid = int(msg["rid"]) if msg.get("rid") is not None else None
            _send(wfile, {"ok": True, **self.sched.metrics(rid)})
        elif op == "cache_stats":
            _send(wfile, {"ok": True, **self.sched.cache_stats()})
        elif op == "cancel":
            cancelled = self.sched.cancel(_rid(msg))
            with self._wake:
                self._wake.notify_all()
            _send(wfile, {"ok": True, "cancelled": cancelled})
        elif op == "stream":
            log = self._reader(_rid(msg))
            try:
                for ev in log.iter_events(self._stopped_and_drained):
                    _send(wfile, {"ok": True, **ev})
            finally:
                log.release()
        elif op == "result":
            rid = _rid(msg)
            log = self._reader(rid)
            try:
                for _ev in log.iter_events(self._stopped_and_drained):
                    pass                  # block until the terminal event
                res = self.sched.done.get(rid)
                if res is None:
                    t = self.sched.terminal.get(rid)
                    if t == "cancelled":
                        raise RuntimeError(f"request {rid} was cancelled")
                    if t == "error":
                        raise RuntimeError(self.sched.errors.get(
                            rid, f"request {rid} failed at admission"))
                    # shutdown hit before this solve
                    raise RuntimeError("server shut down before the result")
                out = {"width": res.width, "exact": res.exact,
                       "lb": res.lb, "ub": res.ub,
                       "expanded": res.expanded, "order": res.order,
                       "per_k": res.per_k}
                if self.sched.terminal.get(rid) == "timeout":
                    out["timed_out"] = True
                _send(wfile, {"ok": True, "result": out})
            finally:
                log.release()
        elif op == "shutdown":
            _send(wfile, {"ok": True})
            self._stop.set()
            with self._wake:
                self._wake.notify_all()
            # shut the acceptor down from a side thread (we are inside a
            # handler of this very server)
            threading.Thread(target=self._tcp.shutdown, daemon=True).start()
        else:
            raise ValueError(f"unknown op {op!r}")


def _jsonable(x):
    """json.dumps ``default=``: numpy and torch scalars, arrays and 0-d
    tensors (a result's
    ``order``, ``per_k`` counters, event payload fields) coerce to plain
    Python values instead of killing the wire response."""
    if hasattr(x, "tolist"):
        return x.tolist()
    if hasattr(x, "item"):
        return x.item()
    raise TypeError(f"not JSON serializable: {type(x).__name__}")


def _send(wfile, obj: dict) -> None:
    try:
        wfile.write((json.dumps(obj, default=_jsonable) + "\n").encode())
        wfile.flush()
    except (BrokenPipeError, ConnectionResetError):
        pass                        # client went away mid-stream


def _rid(msg: dict) -> int:
    if "rid" not in msg:
        raise ValueError('missing "rid"')
    return int(msg["rid"])


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="persistent treewidth solve service (JSON lines/TCP)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=DEFAULT_PORT,
                    help=f"TCP port (default {DEFAULT_PORT}; 0 = ephemeral)")
    ap.add_argument("--lanes", type=int, default=8,
                    help="lane pool size: max requests per shared dispatch")
    ap.add_argument("--cap", type=int, default=None,
                    help="frontier rows per lane (power of two). Default: "
                         "auto via batch.plan_capacity")
    ap.add_argument("--budget-mb", type=float, default=None,
                    help="bound the pooled frontier memory; 0 reads the "
                         "device's free-memory stats")
    ap.add_argument("--block", type=int, default=1 << 11)
    ap.add_argument("--mode", default="sort", choices=["sort", "bloom"])
    ap.add_argument("--mmw", action="store_true")
    ap.add_argument("--simplicial", action="store_true")
    ap.add_argument("--backend", default=None, choices=["torch", "cuda"],
                    help="op implementations: plain torch ops or the CUDA "
                         "kernels. Default: cuda on a CUDA device, torch "
                         "elsewhere")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "ops)")
    ap.add_argument("--schedule", default=None,
                    choices=["doubling", "while", "linear", "matmul"])
    ap.add_argument("--no-preprocess", action="store_true")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the admission queue; over-limit submits "
                         "are rejected with a retry_after hint")
    ap.add_argument("--pipeline", type=int, default=1,
                    help="dispatch pipeline depth: rounds kept in flight "
                         "before a sync is forced (2 hides host syncs)")
    ap.add_argument("--prio-weight", type=int, default=4,
                    help="weighted-FIFO anti-starvation ratio: preferential "
                         "admissions per base-class admission")
    ap.add_argument("--donate-ratio", type=float, default=None,
                    help="work-donation trigger for sharded requests "
                         "(submit knob \"shards\"): rebalance when the "
                         "max shard exceeds ratio x mean occupancy "
                         "(default core.shard.DEFAULT_DONATE_RATIO)")
    ap.add_argument("--cache", type=int, default=256, metavar="N",
                    help="content-addressed result cache entries (LRU; "
                         "0 disables). Isomorphic resubmissions resolve "
                         "at submit without touching the device; the "
                         "cache_stats op and the no_cache submit knob "
                         "expose/bypass it (DESIGN.md §16)")
    ap.add_argument("--keep-results", type=int,
                    default=DEFAULT_KEEP_RESULTS,
                    help="finished requests retained for status/result/"
                         "stream replay before the oldest are evicted")
    ap.add_argument("--metrics-jsonl", default=None, metavar="PATH",
                    help="append every telemetry record of the pool's "
                         "scope tree to PATH as JSON lines (the metrics "
                         "op returns snapshots; this streams the raw "
                         "mutation log)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.core import backend as backend_lib

    budget = None
    if args.budget_mb is not None:
        budget = "auto" if args.budget_mb == 0 \
            else int(args.budget_mb * 2**20)
    try:
        srv = TwServer(host=args.host, port=args.port,
                       keep_results=args.keep_results,
                       metrics_jsonl=args.metrics_jsonl,
                       lanes=args.lanes,
                       cap=args.cap, block=args.block, mode=args.mode,
                       use_mmw=args.mmw, use_simplicial=args.simplicial,
                       backend=args.backend, schedule=args.schedule,
                       device=args.device, use_preprocess=not args.no_preprocess,
                       max_queue=args.max_queue, pipeline=args.pipeline,
                       prio_weight=args.prio_weight,
                       donate_ratio=args.donate_ratio,
                       budget_bytes=budget, cache=args.cache,
                       verbose=args.verbose)
    except backend_lib.BackendCapabilityError as e:
        print(f"[twserved] unsupported pool configuration: {e}",
              file=sys.stderr)
        return 2
    srv.start()
    print(f"[twserved] listening on {srv.host}:{srv.port} "
          f"(lanes={args.lanes}, device={srv.sched.device}, "
          f"backend={srv.sched.decide_kw['backend']}, mode={args.mode})",
          flush=True)
    try:
        srv.serve_until_shutdown()
    except KeyboardInterrupt:
        srv.close()
    print("[twserved] shut down", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
