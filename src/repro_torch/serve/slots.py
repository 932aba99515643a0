"""Fixed slot pool + weighted FIFO admission: the continuous-batching core.

Both serving schedulers are the same machine — a fixed pool of B slots,
each holding the in-flight state of one admitted request, advanced by a
shared batched device step, with finished slots recycled to the queue
immediately:

  * ``repro.serve.scheduler``  — LM decode: a slot is a sequence, the
    shared step is one batched decode tick (not ported yet: ROADMAP
    A14);
  * ``repro_torch.serve.twscheduler`` — treewidth solves: a slot is a solve
    request's current deepening rung, the shared step is one multi-lane
    ``batch.decide_lanes`` dispatch.

This module is the slot/admission mechanics they share; everything
workload-specific (what a slot holds, what one step does, when a slot is
finished) stays in the schedulers.  The async treewidth scheduler
additionally relies on admission being pure host bookkeeping: ``admit``
only touches the queue and the slot table, so it is safe to run while a
batched device dispatch over the *occupied* slots is still in flight
(DESIGN.md §11's overlap invariant) — an occupied slot is never handed
out, and a newly filled one simply joins the next dispatch.

Traffic shaping (DESIGN.md §12) lives at this layer too, because both
schedulers need it and it is pure queue mechanics:

  * **priority classes** — ``submit(item, priority=p)`` files the item
    under integer class ``p`` (higher = more urgent, FIFO within a
    class).  Admission pops from the most urgent non-empty class, but a
    weighted anti-starvation counter guarantees the least urgent class
    one admission per ``prio_weight`` preferential pops — high-priority
    requests jump the queue without starving the base class.
  * **backpressure** — ``max_queue`` bounds the number of *queued*
    (not yet admitted) items; an over-limit ``submit`` raises
    ``QueueFull`` instead of growing the queue unboundedly.  The
    scheduler layer turns that into a reject-with-``retry_after`` reply.

Runnable example::

    pool = SlotPool(2)
    pool.submit("a"); pool.submit("b"); pool.submit("c")
    pool.submit("z", priority=1)            # jumps the FIFO
    pool.admit(lambda item: item.upper())   # -> [(0, "A"), (1, "B")]
    pool.release(0)                         # slot 0 recycles ...
    pool.admit(lambda item: item.upper())   # -> [(0, "Z")]  (priority)

A copy of ``repro.serve.slots`` (pure Python) over the port's own
``telemetry``, so that the PyTorch port never imports ``repro``.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from repro_torch.core import telemetry


class QueueFull(RuntimeError):
    """The admission queue is at ``max_queue``: shed this submit.

    ``retry_after`` (seconds, may be ``None`` at the pool layer) is the
    caller-facing hint: the scheduler estimates it from its recent round
    wall-clock and queue depth before surfacing the rejection.
    """

    def __init__(self, msg: str, retry_after: Optional[float] = None):
        super().__init__(msg)
        self.retry_after = retry_after


class _Shadow:
    """Occupancy marker for the extra slots of a multi-slot admission.

    A request admitted with width S occupies one *primary* slot (holding
    the caller state) plus S-1 shadow slots pointing back at it; shadows
    keep ``free`` honest and are recycled with their primary."""

    __slots__ = ("primary",)

    def __init__(self, primary: int):
        self.primary = primary


class SlotPool:
    """``n_slots`` recyclable slots fed from weighted-FIFO priority queues.

    A slot is either ``None`` (free) or an arbitrary caller state object.
    ``admit`` pops queued items into free slots through a caller ``start``
    callback, which may return ``None`` to signal "finished at admission"
    (e.g. a trivial instance) — the slot then immediately tries the next
    queued item, so trivial requests never waste a batched step.

    ``max_queue`` bounds the queued backlog (``QueueFull`` on overflow);
    ``prio_weight`` is the anti-starvation ratio: at most that many
    consecutive preferential pops before the least urgent waiting class
    is served once.

    ``slots_of`` (optional) maps a queued item to the number of slots it
    occupies — the sharded-request hook: a width-S item is admitted only
    when S slots are free, filling one primary slot plus S-1 ``_Shadow``
    markers that release together.  Admission is head-of-line: when the
    most urgent queued item does not fit, admission stops rather than
    skipping it, so wide requests cannot be starved by a stream of narrow
    ones (the flip side: narrow items behind a waiting wide one wait too
    — DESIGN.md §13)."""

    def __init__(self, n_slots: int, *, max_queue: Optional[int] = None,
                 prio_weight: int = 4,
                 slots_of: Optional[Callable[[object], int]] = None,
                 tracker=None):
        if n_slots < 1:
            raise ValueError(f"need at least one slot (got {n_slots})")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 (got {max_queue})")
        self.slots: List[Optional[object]] = [None] * n_slots
        self.max_queue = max_queue
        self.prio_weight = max(1, int(prio_weight))
        self.slots_of = slots_of
        # Pool-level queue mechanics telemetry; NULL (no-op) unless the
        # owning scheduler hands us its pool tracker.
        self.tracker = telemetry.NULL if tracker is None else tracker
        self._queues: Dict[int, deque] = {}   # priority class -> FIFO
        self._starve = 0   # consecutive preferential pops while base waits

    def __len__(self) -> int:
        return len(self.slots)

    # ------------------------------------------------------------- queueing

    def submit(self, item, priority: int = 0) -> None:
        if self.max_queue is not None and self.qsize >= self.max_queue:
            self.tracker.count(queue_rejections=1)
            raise QueueFull(
                f"admission queue full ({self.qsize} queued, "
                f"max_queue={self.max_queue}); retry later")
        self._queues.setdefault(int(priority), deque()).append(item)
        self.tracker.count(queue_submits=1)
        self.tracker.gauge("queue_depth", self.qsize)

    @property
    def qsize(self) -> int:
        """Items queued (admitted items do not count)."""
        return sum(len(q) for q in self._queues.values())

    def queued(self) -> Iterator[object]:
        """Queued items, most urgent class first, FIFO within a class."""
        for p in sorted(self._queues, reverse=True):
            yield from self._queues[p]

    @property
    def queue(self) -> list:
        """Snapshot of the queued items in class-then-FIFO order."""
        return list(self.queued())

    def discard(self, pred: Callable[[object], bool]) -> Optional[object]:
        """Remove and return the first queued item matching ``pred``
        (cancellation of a not-yet-admitted request); None if absent."""
        for p, q in list(self._queues.items()):
            for item in q:
                if pred(item):
                    q.remove(item)
                    if not q:
                        del self._queues[p]
                    return item
        return None

    def _pick(self) -> Optional[int]:
        """The priority class the next pop serves (no state mutated)."""
        prios = sorted((p for p, q in self._queues.items() if q),
                       reverse=True)
        if not prios:
            return None
        if len(prios) > 1 and self._starve >= self.prio_weight:
            return prios[-1]
        return prios[0]

    def _peek(self):
        """The item the next ``_pop`` would return (queues untouched)."""
        pick = self._pick()
        return None if pick is None else self._queues[pick][0]

    def _pop(self):
        """Weighted-FIFO pop: most urgent class wins, except that after
        ``prio_weight`` consecutive preferential pops while a less urgent
        class waits, the least urgent class is served once."""
        pick = self._pick()
        if pick is None:
            return None
        prios = sorted((p for p, q in self._queues.items() if q),
                       reverse=True)
        if len(prios) == 1:
            self._starve = 0
        elif pick == prios[-1] and self._starve >= self.prio_weight:
            self._starve = 0
        else:
            self._starve += 1
        q = self._queues[pick]
        item = q.popleft()
        if not q:
            del self._queues[pick]
        return item

    # ------------------------------------------------------------ admission

    def _width(self, item) -> int:
        return max(1, int(self.slots_of(item))) if self.slots_of else 1

    def admit(self, start: Callable[[object], Optional[object]]
              ) -> List[Tuple[int, object]]:
        """Fill free slots from the queues; returns [(slot index, state)].

        A width-S item (``slots_of``) is placed in the lowest free slot
        with S-1 shadows in the next free ones; the returned index is the
        primary.  Admission stops at the first queued item that does not
        fit (head-of-line, see class docstring)."""
        admitted = []
        while True:
            item = self._peek()
            if item is None:
                break
            need = self._width(item)
            free = [i for i, s in enumerate(self.slots) if s is None]
            if len(free) < need:
                break
            state = start(self._pop())
            if state is None:
                continue          # finished at admission; slot stays free
            primary = free[0]
            self.slots[primary] = state
            for j in free[1:need]:
                self.slots[j] = _Shadow(primary)
            admitted.append((primary, state))
        if admitted:
            self.tracker.count(admissions=len(admitted))
        self.tracker.gauge("queue_depth", self.qsize)
        return admitted

    def release(self, i: int) -> None:
        """Free slot ``i`` and any shadows it anchors (one call recycles a
        sharded request's whole slot group)."""
        self.slots[i] = None
        for j, s in enumerate(self.slots):
            if isinstance(s, _Shadow) and s.primary == i:
                self.slots[j] = None

    def active(self) -> List[Tuple[int, object]]:
        """Occupied slots in slot order (the batched-step iteration set).

        One entry per admitted item: shadow slots of a multi-slot
        admission are occupied but not listed."""
        return [(i, s) for i, s in enumerate(self.slots)
                if s is not None and not isinstance(s, _Shadow)]

    @property
    def free(self) -> int:
        """Slots currently available to admission."""
        return sum(1 for s in self.slots if s is None)

    @property
    def busy(self) -> bool:
        """Anything queued or in flight?"""
        return bool(self.qsize) or any(s is not None for s in self.slots)
