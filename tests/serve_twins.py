"""Shared plumbing of the serving twins (``tests/test_torch_twserve*.py``,
``test_torch_cache.py``, ``test_torch_twserved.py``).

A twin runs one scenario through the reference package (``repro``, JAX on
the CPU) and through the port (``repro_torch`` with ``device="cpu"``) and
asserts that every request got the same thing: the result surface
(``width``, ``exact``, ``lb``, ``ub``, ``expanded``, ``per_k``, ``order``)
and the event stream, event by event.

Only the fields that read a clock are dropped before comparing (and the
process-wide pool number in telemetry scope names is masked, see
``unclock``):

  * ``SolveResult.time_sec``;
  * the ``timings`` of every telemetry snapshot (``admission_s``,
    ``request_s``, ``round_s``, ``heur_admit_s``; the reference's
    ``dispatch_wall_s``; the port's spans ``preprocess_s``, ``plan_s``,
    ``level_s`` and ``read_s``), which ride in the terminal events'
    ``metrics``.

A scenario is a function of one package namespace (``REF`` or ``PORT``):
``pkg.graph``, ``pkg.solver``, ``pkg.TwScheduler`` and ``pkg.kw``, the
keywords that pin the package's device in a scheduler or a solve (the
port runs on the card unless asked for the CPU).
"""
import re
import types

import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import graph as ref_graph
from repro.core import solver as ref_solver
from repro.core import telemetry as ref_telemetry
from repro.serve import cache as ref_cache
from repro.serve import slots as ref_slots
from repro.serve import twscheduler as ref_tws
from repro_torch.core import engine as port_engine
from repro_torch.core import graph as port_graph
from repro_torch.core import solver as port_solver
from repro_torch.core import telemetry as port_telemetry
from repro_torch.serve import cache as port_cache
from repro_torch.serve import slots as port_slots
from repro_torch.serve import twscheduler as port_tws

REF = types.SimpleNamespace(
    graph=ref_graph, solver=ref_solver, engine=ref_engine,
    TwScheduler=ref_tws.TwScheduler,
    ResultCache=ref_cache.ResultCache, QueueFull=ref_slots.QueueFull,
    SlotPool=ref_slots.SlotPool, Tracker=ref_telemetry.Tracker, kw={})
PORT = types.SimpleNamespace(
    graph=port_graph, solver=port_solver, engine=port_engine,
    TwScheduler=port_tws.TwScheduler,
    ResultCache=port_cache.ResultCache, QueueFull=port_slots.QueueFull,
    SlotPool=port_slots.SlotPool, Tracker=port_telemetry.Tracker,
    kw={"device": "cpu"})


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test workers run side by side; one torch thread each keeps them from
    oversubscribing the CPU (the results do not depend on it).  Every twin
    file imports it, which makes it autouse there."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# the clocked fields, by name (see the module docstring)
CLOCK_FIELDS = ("time_sec", "timings")


def sched(pkg, **kw):
    """A scheduler of ``pkg`` on its test device."""
    return pkg.TwScheduler(**pkg.kw, **kw)


def solve(pkg, g, **kw):
    return pkg.solver.solve(g, **pkg.kw, **kw)


def surface(r):
    """A result's unclocked surface (None stays None)."""
    if r is None:
        return None
    order = None if r.order is None else [int(v) for v in r.order]
    return (int(r.width), bool(r.exact), int(r.lb), int(r.ub),
            int(r.expanded), r.per_k, order)


def unclock(x):
    """``x`` with every clocked field dropped, recursively, and the pool
    number of telemetry ``scope`` names (``pool<N>/req<rid>``) masked:
    ``N`` counts the schedulers a process has built so far, which
    differs between the two packages within one test process."""
    if isinstance(x, dict):
        return {k: (re.sub(r"^pool\d+", "pool", v)
                    if k == "scope" and isinstance(v, str) else unclock(v))
                for k, v in x.items() if k not in CLOCK_FIELDS}
    if isinstance(x, (list, tuple)):
        return type(x)(unclock(v) for v in x)
    return x


class Events:
    """An ``on_event`` sink that files every event under its rid."""

    def __init__(self):
        self.by_rid = {}

    def __call__(self, ev):
        self.by_rid.setdefault(ev["rid"], []).append(ev)

    def of(self, rid):
        return self.by_rid.get(rid, [])

    def unclocked(self):
        return {rid: unclock(evs) for rid, evs in self.by_rid.items()}


def record(sched_, rids, events=None):
    """What a scenario compares: per-request surfaces and terminal
    states, the unclocked event streams, and the scheduler's round
    accounting."""
    return {
        "results": {r: surface(sched_.done.get(r)) for r in rids},
        "terminal": {r: sched_.terminal.get(r) for r in rids},
        "events": None if events is None else events.unclocked(),
        "rounds": sched_.rounds,
    }


def twin(scenario, *args, **kw):
    """Run ``scenario`` on both packages and assert equal records.

    Keys of the record that start with ``_`` are not compared: they carry
    what is not part of the contract (dispatch and host-sync counts) for
    each side's own assertions.  Returns ``(ref_record, port_record)``."""
    ref = scenario(REF, *args, **kw)
    port = scenario(PORT, *args, **kw)
    a = {k: v for k, v in port.items() if not str(k).startswith("_")}
    b = {k: v for k, v in ref.items() if not str(k).startswith("_")}
    assert a == b, diff(a, b)
    return ref, port


def diff(a, b, path="", out=None):
    """The first few paths at which ``a`` (port) and ``b`` (reference)
    differ, with both values: the failure message of ``twin``."""
    out = [] if out is None else out
    if len(out) >= 8:
        return out
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=repr):
            if k not in a or k not in b:
                out.append(f"{path}/{k!r}: only in "
                           f"{'reference' if k in b else 'port'}")
            else:
                diff(a[k], b[k], f"{path}/{k!r}", out)
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)) \
            and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            diff(x, y, f"{path}[{i}]", out)
    elif a != b:
        out.append(f"{path}: port {a!r} != reference {b!r}")
    return out
