"""Scoped, pluggable telemetry: the observability substrate (DESIGN.md §14).

A copy of ``repro.core.telemetry`` (pure Python) so that the PyTorch port
never imports ``repro``.

The paper's whole evaluation (Tables 1–6) is work-size and timing
measurement, but the reproduction grew up funnelling everything through
one process-global dict (``engine.COUNTERS``) — no per-request
attribution, no timings, no way to stream scheduler health off the box,
and a latent race once the twserved driver thread started mutating it
while the main thread read.  This module replaces that with a tree of
``Tracker`` scopes:

  * ``count(name=delta, ...)`` — monotone counters.  A count made on a
    child scope **writes through** to every ancestor atomically, so a
    request scope's counters sum exactly into the pool scope's totals by
    construction (no snapshot-time aggregation to race against).
  * ``gauge(name, value)`` — last-value gauges, recorded on the scope
    they are set on (a parent's "last value" of a child gauge is
    meaningless, so gauges do not roll up).
  * ``gauge_max(name, value)`` — high-watermark gauges; the ratchet
    *does* write through (the pool's peak is the max over its requests).
    ``shard_peak_occupancy`` keeps its legacy max-not-sum semantics here.
  * ``time_block(name)`` — a span: a context manager accumulating
    wall-clock into ``timings[name] = {calls, total_s, max_s}``; its
    sink record also carries ``start_ns``/``end_ns`` on the profiler's
    clock (epoch nanoseconds, ``time.time_ns``) and ``parent``, the name
    of the span open around it on the same thread.  While
    ``torch.profiler`` records, the span is also a profiler range of its
    name on the host timeline (``_RecordFunctionFast``: not a user
    annotation, so kineto mirrors no device row for it).
    ``timing(name, s)`` is the direct form for spans measured by hand.
    Timings roll up like counters.
  * ``child(scope)`` — a sub-scope sharing the tree's single lock.
    ``child`` is idempotent per name; ``drop_child`` detaches a finished
    scope (its contributions remain in the ancestors' totals).
  * sinks — every mutation emits one record ``{"ts", "scope", "kind",
    ...}`` to the sinks attached at the call scope *and* every ancestor
    (attach a ``JsonlSink`` at the root and the whole tree streams).
    ``InMemorySink`` buffers records, ``JsonlSink`` appends JSON lines,
    ``StdoutSink`` prints — all duck-typed on ``emit(record)``.

Thread safety: one ``RLock`` per tree, shared by every scope (children
inherit the root's).  All reads (``snapshot``, ``value``, the legacy
``COUNTERS`` view) and writes take it, which fixes the twserved
driver-thread race.  Event rates are per *dispatch/rung/request*, never
per state, so a single lock is nowhere near contended.

Overhead: the default for hot paths is ``NULL`` — a ``NullTracker``
singleton whose methods are empty and whose ``time_block`` returns a
shared no-op context manager; passing it costs one attribute call per
dispatch.  Library entry points take ``tracker=None`` meaning "the
process root" (``telemetry.root()``), preserving the legacy global
accounting that ~30 existing tests assert through the deprecated
read-only ``COUNTERS`` mapping below.
"""
from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, Dict, IO, Iterator, List, Mapping, Optional


# ------------------------------------------------------------------ sinks

class InMemorySink:
    """Buffer every record in order; ``records`` is the log, ``clear()``
    empties it.  Emission happens under the tree lock, so the order seen
    here is the true global mutation order."""

    def __init__(self) -> None:
        self.records: List[dict] = []

    def emit(self, record: dict) -> None:
        self.records.append(record)

    def clear(self) -> None:
        self.records.clear()


class JsonlSink:
    """Append one JSON line per record to ``path`` (or an open file).

    Flushes per record so the artifact is complete even if the process
    dies mid-run — these are benchmark/CI artifacts, not a hot path.
    """

    def __init__(self, path_or_file: Any) -> None:
        if hasattr(path_or_file, "write"):
            self._f: IO[str] = path_or_file
            self._owns = False
        else:
            self._f = open(path_or_file, "a", encoding="utf-8")
            self._owns = True

    def emit(self, record: dict) -> None:
        self._f.write(json.dumps(record, sort_keys=True) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._owns:
            self._f.close()


class StdoutSink:
    """Human-oriented one-line-per-record printer (debugging aid)."""

    def __init__(self, file: Optional[IO[str]] = None) -> None:
        self._f = file if file is not None else sys.stdout

    def emit(self, record: dict) -> None:
        scope = record.get("scope") or "<root>"
        kind = record.get("kind")
        if kind == "count":
            body = " ".join(f"{k}+={v}"
                            for k, v in sorted(record["counters"].items()))
        elif kind in ("gauge", "gauge_max"):
            body = f"{record['name']}={record['value']}"
        else:
            body = f"{record['name']}={record['seconds']:.6f}s"
        print(f"[telemetry] {scope} {kind} {body}", file=self._f)


# ------------------------------------------------------------- time block

# the names of the spans open on each thread, innermost last
_OPEN = threading.local()


def _open_spans() -> List[str]:
    stack = getattr(_OPEN, "names", None)
    if stack is None:
        stack = _OPEN.names = []
    return stack


def _profiler_range(name: str) -> Any:
    """An entered profiler range named ``name`` while ``torch.profiler``
    records, else ``None`` (torch is not imported for this)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rng = torch._C._profiler._RecordFunctionFast(name)
    rng.__enter__()
    return rng


class _TimeBlock:
    """Context manager created by ``Tracker.time_block``: measures
    ``perf_counter`` wall-clock and records it on exit (also on
    exception — a failed span still took time), with its start and end
    in epoch nanoseconds and its parent span."""

    __slots__ = ("_tracker", "_name", "_t0", "_start_ns", "_parent",
                 "_range")

    def __init__(self, tracker: "Tracker", name: str) -> None:
        self._tracker = tracker
        self._name = name
        self._t0 = 0.0

    def __enter__(self) -> "_TimeBlock":
        stack = _open_spans()
        self._parent = stack[-1] if stack else None
        stack.append(self._name)
        self._range = _profiler_range(self._name)
        self._start_ns = time.time_ns()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        seconds = time.perf_counter() - self._t0
        end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _open_spans().pop()
        self._tracker._timing(self._name, seconds,
                              (self._start_ns, end_ns, self._parent))


class _NullCtx:
    __slots__ = ()

    def __enter__(self) -> "_NullCtx":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


_NULL_CTX = _NullCtx()


# ---------------------------------------------------------------- tracker

class Tracker:
    """One scope in the telemetry tree.  See the module docstring for the
    write-through/roll-up rules.  Constructing ``Tracker()`` with no
    parent makes an independent root (benchmarks do this to isolate a
    measurement from the process-global accounting)."""

    def __init__(self, scope: str = "", parent: Optional["Tracker"] = None,
                 sinks: Optional[List[Any]] = None) -> None:
        self.scope = scope
        self._parent = parent
        self._lock = parent._lock if parent is not None else threading.RLock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._timings: Dict[str, List[float]] = {}  # [calls, total_s, max_s]
        self._sinks: List[Any] = list(sinks or ())
        self._children: Dict[str, "Tracker"] = {}

    # -- scope tree

    def child(self, scope: str) -> "Tracker":
        """Get-or-create the named sub-scope (idempotent per name)."""
        with self._lock:
            tr = self._children.get(scope)
            if tr is None:
                full = f"{self.scope}/{scope}" if self.scope else scope
                tr = Tracker(full, parent=self)
                self._children[scope] = tr
            return tr

    def drop_child(self, scope: str) -> None:
        """Detach a finished sub-scope.  Its write-through contributions
        stay in this scope's totals; only the per-scope breakdown goes."""
        with self._lock:
            self._children.pop(scope, None)

    def add_sink(self, sink: Any) -> None:
        with self._lock:
            self._sinks.append(sink)

    # -- mutation

    def count(self, **counters: float) -> None:
        """Add the given deltas to this scope and every ancestor."""
        if not counters:
            return
        with self._lock:
            sinks = []
            node: Optional[Tracker] = self
            while node is not None:
                c = node._counters
                for key, val in counters.items():
                    c[key] = c.get(key, 0) + val
                sinks.extend(node._sinks)
                node = node._parent
            if sinks:
                self._emit(sinks, {"kind": "count", "counters": dict(counters)})

    def gauge(self, name: str, value: float) -> None:
        """Record a last-value gauge on this scope only (no roll-up)."""
        with self._lock:
            self._gauges[name] = value
            sinks = self._collect_sinks()
            if sinks:
                self._emit(sinks, {"kind": "gauge", "name": name,
                                   "value": value})

    def gauge_max(self, name: str, value: float) -> None:
        """Ratchet a high-watermark gauge on this scope and every
        ancestor (the parent's peak is the max over its children)."""
        with self._lock:
            node: Optional[Tracker] = self
            while node is not None:
                g = node._gauges
                if value > g.get(name, value - 1):
                    g[name] = value
                node = node._parent
            sinks = self._collect_sinks()
            if sinks:
                self._emit(sinks, {"kind": "gauge_max", "name": name,
                                   "value": value})

    def timing(self, name: str, seconds: float) -> None:
        """Accumulate a measured span into this scope and every ancestor."""
        self._timing(name, seconds, None)

    def _timing(self, name: str, seconds: float,
                span: Optional[tuple]) -> None:
        """``timing``; ``span`` is ``(start_ns, end_ns, parent)`` of a
        ``time_block``, put in the sink record only when a sink listens."""
        with self._lock:
            node: Optional[Tracker] = self
            while node is not None:
                t = node._timings.get(name)
                if t is None:
                    node._timings[name] = [1, seconds, seconds]
                else:
                    t[0] += 1
                    t[1] += seconds
                    t[2] = max(t[2], seconds)
                node = node._parent
            sinks = self._collect_sinks()
            if sinks:
                rec = {"kind": "time", "name": name, "seconds": seconds}
                if span is not None:
                    rec.update(start_ns=span[0], end_ns=span[1],
                               parent=span[2])
                self._emit(sinks, rec)

    def time_block(self, name: str) -> _TimeBlock:
        """A span named ``name`` on this scope (module docstring)."""
        return _TimeBlock(self, name)

    # -- reads

    def value(self, name: str, default: float = 0) -> float:
        """Counter value (falling back to gauges) by name."""
        with self._lock:
            if name in self._counters:
                return self._counters[name]
            return self._gauges.get(name, default)

    def __getitem__(self, name: str) -> float:
        return self.value(name)

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def snapshot(self, children: bool = True) -> dict:
        """A plain-JSON view of this scope (and, by default, the live
        sub-tree).  Safe to hand across threads or the wire."""
        with self._lock:
            snap: Dict[str, Any] = {
                "scope": self.scope,
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "timings": {name: {"calls": t[0], "total_s": t[1],
                                   "max_s": t[2]}
                            for name, t in self._timings.items()},
            }
            if children:
                snap["children"] = {name: tr.snapshot(children=True)
                                    for name, tr in self._children.items()}
            return snap

    def reset(self) -> None:
        """Zero this scope and the live sub-tree (structure is kept:
        children stay attached so long-lived scopes survive a reset)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timings.clear()
            for tr in self._children.values():
                tr.reset()

    # -- internals (call under lock)

    def _collect_sinks(self) -> List[Any]:
        sinks: List[Any] = []
        node: Optional[Tracker] = self
        while node is not None:
            sinks.extend(node._sinks)
            node = node._parent
        return sinks

    def _emit(self, sinks: List[Any], record: dict) -> None:
        record["ts"] = time.time()
        record["scope"] = self.scope
        seen = set()
        for sink in sinks:
            if id(sink) in seen:
                continue
            seen.add(id(sink))
            sink.emit(record)


class NullTracker:
    """The near-zero-overhead default for hot paths: every method is a
    no-op, ``child`` returns itself, ``time_block`` hands back one shared
    no-op context manager.  Use the ``NULL`` singleton."""

    scope = ""

    def child(self, scope: str) -> "NullTracker":
        return self

    def drop_child(self, scope: str) -> None:
        pass

    def add_sink(self, sink: Any) -> None:
        pass

    def count(self, **counters: float) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def gauge_max(self, name: str, value: float) -> None:
        pass

    def timing(self, name: str, seconds: float) -> None:
        pass

    def time_block(self, name: str) -> _NullCtx:
        return _NULL_CTX

    def value(self, name: str, default: float = 0) -> float:
        return default

    def __getitem__(self, name: str) -> float:
        return 0

    def counters(self) -> Dict[str, float]:
        return {}

    def snapshot(self, children: bool = True) -> dict:
        return {"scope": "", "counters": {}, "gauges": {}, "timings": {}}

    def reset(self) -> None:
        pass


NULL = NullTracker()

# the process root: what ``tracker=None`` resolves to everywhere, and what
# the deprecated ``COUNTERS`` view below reads
_ROOT = Tracker()


def root() -> Tracker:
    return _ROOT


def get(tracker: Optional[Any]) -> Any:
    """Resolve a ``tracker=`` argument: ``None`` means the process root
    (legacy global accounting); anything else is used as-is."""
    return _ROOT if tracker is None else tracker


def reset() -> None:
    """Zero the process root (the body of ``engine.reset_counters``)."""
    _ROOT.reset()


# ------------------------------------------------- deprecated COUNTERS view

# the six keys the pre-telemetry global dict carried; the view is frozen
# to them so ``dict(engine.COUNTERS)`` keeps its historical shape even as
# new counters land in the root tracker
LEGACY_KEYS = (
    "dispatches",
    "host_syncs",
    "shard_donations",
    "shard_donated_rows",
    "shard_idle_steps",
    "shard_peak_occupancy",
)


class _CountersView(Mapping):
    """Read-only mapping over the root tracker, shaped like the old
    ``engine.COUNTERS`` dict.  Deprecated: new code reads
    ``telemetry.root().snapshot()`` (or its own ``Tracker``) instead.
    Writes go through ``Tracker.count`` / ``gauge_max`` — item assignment
    here raises, which is what keeps ``grep COUNTERS\\[`` honest."""

    def __getitem__(self, key: str) -> float:
        if key not in LEGACY_KEYS:
            raise KeyError(key)
        return _ROOT.value(key)

    def __iter__(self) -> Iterator[str]:
        return iter(LEGACY_KEYS)

    def __len__(self) -> int:
        return len(LEGACY_KEYS)

    def __repr__(self) -> str:
        return f"COUNTERS({dict(self)!r})"


COUNTERS = _CountersView()
