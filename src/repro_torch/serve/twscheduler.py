"""Treewidth solve service: asynchronous continuous batching of requests.

A port of ``repro.serve.twscheduler`` to the PyTorch engine: the same
admission, ladder, cache, traffic-shaping and event logic over the port's
``batch.decide_lanes_async`` (the lane forms of the wavefront and Bloom
kernels), ``shard.decide_sharded_async`` and
``bounds_engine.ub_orders_async``.  The pool runs on ``device`` (the card
unless the caller asks for the CPU) with ``backend`` (``cuda`` on a card,
``torch`` elsewhere).  The port's dispatches run their whole rung before
the handle returns (``DispatchHandle.ready()`` is true at once), so a
``pipeline`` overlap and a mid-dispatch ``cancel`` act at rung
boundaries: results, ``per_k`` and event streams are the reference's,
dispatch and host-sync counts need not be.  The reference's notes
follow.

The paper keeps the GPU busy by batching many independent wavefront
expansions per dispatch; this module applies the same principle one level
up, at the *request* level, and keeps the host busy too.  A fixed pool of
L lanes (``repro.serve.slots.SlotPool`` — the admission core shared with
the LM scheduler) runs continuous batching over concurrent ``solve``
requests:

  * each admitted request holds one lane with its current iterative-
    deepening rung — the ``(adj, allowed, k)`` of its current
    preprocessed block at its current k;
  * every scheduler step packs all occupied lanes into shared multi-lane
    dispatches (``batch.decide_lanes_async``, DESIGN.md §8/§11): the
    vmapped ``decide_loop`` runs every rung concurrently, a finished
    lane's masked early-exit freezing its carry while the others step;
  * the dispatch is **launched without blocking** (in the reference,
    JAX async dispatch: the device arrays are held in an
    ``engine.DispatchHandle``, the host sync is deferred; in the port
    the rung has run when the handle returns).  While the device works,
    the scheduler runs
    admission and planning for newly arrived requests — they take free
    slots immediately and are packed into the *next* dispatch instead of
    waiting for an idle pool (DESIGN.md §11's overlap pipeline);
  * when the verdicts are synced, each lane's result is fed to its
    request's ``batch.InstanceState`` (the same per-rung accounting
    ``solve``/``solve_many`` use, so results are bit-identical to
    sequential ``solver.solve`` per request) and the slot is immediately
    recycled — to the request's next rung, its next block, or the next
    queued request.

**Traffic shaping (DESIGN.md §12).**  The pool degrades gracefully under
load instead of queuing unboundedly or holding lanes hostage:

  * ``cancel(rid)`` frees the request's lane mid-ladder (queued requests
    are dropped from the queue); in-flight verdicts for a cancelled rid
    are discarded *uncounted* and a terminal ``cancelled`` event is
    emitted;
  * ``submit(deadline_s=...)`` preempts the lane at the first ``sync``
    past the deadline and resolves the request with its monotone
    best-so-far anytime ``lb``/``ub`` (``exact=False``) — Tamaki's
    anytime framing: a timed-out request returns bounds, not nothing;
  * ``submit(priority=...)`` files the request under a priority class:
    admission pops the most urgent class first but guarantees the base
    class one admission per ``prio_weight`` preferential pops
    (weighted FIFO — no starvation);
  * ``max_queue`` bounds the admission queue; over-limit submits raise
    ``slots.QueueFull`` carrying a ``retry_after`` hint estimated from
    the recent round wall-clock and the backlog depth;
  * ``pipeline`` raises the dispatch depth above 1: round N+1's rungs
    (each lane's *projected* next ladder steps) are launched over
    ``engine.DispatchHandle`` before round N syncs, so the device stays
    busy across the host-sync gap.  A rung the sequential ladder never
    ran (its block decided earlier) is discarded uncounted at sync —
    §8's speculation semantics — so parity and COUNTERS semantics are
    preserved; ``idle_syncs``/``covered_syncs`` count how often a sync
    left the device idle vs covered by a queued round.

**Per-request knobs.**  Each ``submit`` may override the pool's dedup
``mode``, the pruning flags (``use_mmw``/``use_simplicial``), pin an
explicit frontier ``cap``, or claim a larger lane share (``speculate`` —
that many consecutive deepening rungs per dispatch, smallest feasible
wins, accounting identical to the sequential ladder).  Requests whose
effective configs match share one vmapped program; incompatible configs
fall back to sub-pool dispatches within the same step (one dispatch per
config group).  An override the backend cannot run raises
``BackendCapabilityError`` from that ``submit`` alone — the pool and its
other requests are unaffected.

**Streaming.**  ``submit(..., on_event=cb)`` streams anytime progress in
the spirit of Tamaki's heuristic-computation work (PAPERS.md): per-rung
``rung_started``/``rung_decided`` events carrying running instance-level
``lb``/``ub`` (lb never decreases, ub never increases; they meet at the
width when the result is exact) and the ``per_k`` delta, then one
terminal event — ``done`` (with ``timed_out: true`` when a deadline
preempted the request), ``cancelled``, or ``error`` (admission failed).
Per request, ``seq`` is strictly increasing, a block's ``rung_decided``
events arrive in increasing k, and the terminal event is last — see
DESIGN.md §11/§12 for the ordering/monotonicity guarantees.  Sinks are
invoked *outside* the scheduler lock (events are buffered under the lock
and delivered after release), so a slow sink never stalls dispatch.

Fairness is structural: admission is weighted FIFO, and every in-flight
request advances exactly one rung (or its ``speculate`` share) per step.

Memory: per-lane frontier buffers are sized by ``batch.plan_capacity``
(``cap=None``); ``budget_bytes`` bounds the step's whole resident
footprint — when config groups, speculation or pipelining make several
dispatches resident at once, the budget is split across them (explicit
per-request ``cap``s are user-pinned and bypass it) — and compiled-
program churn is bounded by ratcheting the padded vertex count, the
planned cap (per config group) and the lane axis — a steady-state
service hits one compiled program per live config group.  See DESIGN.md
§10 (service + memory planning), §11 (async pipeline, grouping, event
guarantees, parity argument) and §12 (traffic shaping).

Runnable example (blocking drain; see ``repro.launch.twserved`` for the
persistent process and ``repro.serve.client`` for its client)::

    from repro_torch.core import graph
    from repro_torch.serve.twscheduler import TwScheduler

    events = []
    sched = TwScheduler(lanes=4, block=32, device="cpu")
    sched.submit(graph.petersen(), on_event=events.append)
    sched.submit(graph.myciel(3), use_mmw=True)    # per-request knob
    rid = sched.submit(graph.queen(5), priority=1) # jumps the queue
    sched.cancel(rid)                              # ... and is abandoned
    results = sched.run()                          # {rid: SolveResult}
    assert events[-1]["event"] == "done"
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core import backend as backend_lib
from repro_torch.core import batch, bitset, bloom
from repro_torch.core import bounds_engine
from repro_torch.core import canon
from repro_torch.core import engine as engine_lib
from repro_torch.core import frontier as frontier_lib
from repro_torch.core import shard as shard_lib
from repro_torch.core import solver as solver_lib
from repro_torch.core import telemetry
from repro_torch.core.graph import Graph

from .cache import ResultCache
from .slots import QueueFull, SlotPool

# Each scheduler instance gets a uniquely-scoped pool tracker (child of
# the process root unless the caller supplies one): test suites build
# many pools per process, and sharing one "pool" scope would merge
# their counters.
_POOL_SEQ = itertools.count()


@dataclasses.dataclass
class SolveRequest:
    """One user query: compute tw(g), optionally with a certified order.

    Fields beyond ``rid``/``g`` are the per-request knobs (``None`` means
    "inherit the pool default"): ``mode`` picks the dedup (``"sort"`` /
    ``"bloom"``), ``use_mmw``/``use_simplicial`` the pruning,
    ``cap`` pins an explicit frontier buffer, and ``speculate`` the lane
    share (that many consecutive deepening rungs per dispatch).
    ``shards`` > 1 scales the request *out* instead of deep: it occupies
    that many pool slots and each of its rungs runs as one sharded
    dispatch (``core.shard``) whose frontier is split across ``shards``
    lanes with work donation — bit-identical verdicts, fewer scheduler
    rounds for heavy instances.
    ``priority`` is the admission class (higher = more urgent) and
    ``deadline`` the absolute ``time.monotonic()`` instant past which the
    request is preempted with its anytime bounds.  ``on_event`` receives
    the streaming event dicts (module docstring).

        req = SolveRequest(0, graph.petersen(), mode="bloom", speculate=2)
    """
    rid: int
    g: Graph
    reconstruct: bool = False
    start_k: Optional[int] = None
    mode: Optional[str] = None
    use_mmw: Optional[bool] = None
    use_simplicial: Optional[bool] = None
    cap: Optional[int] = None
    speculate: int = 1
    shards: int = 1
    priority: int = 0
    deadline: Optional[float] = None
    on_event: Optional[Callable[[dict], None]] = None
    # anytime bounds-engine knobs (core.bounds_engine, DESIGN.md §15):
    # ``heuristics`` is the improver-round budget (None = pool default),
    # ``heuristic_only`` serves bounds without any exact rung and
    # terminates with exact=(lb==ub), ``seed`` pins every heuristic for
    # bit-reproducible bounds (None = pool seed)
    heuristics: Optional[int] = None
    heuristic_only: bool = False
    seed: Optional[int] = None
    # result-cache opt-out (DESIGN.md §16): True forces a fresh solve and
    # suppresses both lookup and insertion for this request
    no_cache: bool = False
    # set by the scheduler at submit/admission (not caller knobs):
    # per-request telemetry child scope, submit instant (admission
    # latency), and the round count at admission (rounds-per-request);
    # cache_key/cache_perm are stamped on a cache miss so ``_finish``
    # knows where (and through which canonical relabeling) to insert
    tracker: object = None
    t_submit: float = 0.0
    round_admitted: int = 0
    cache_key: Optional[str] = None
    cache_perm: Optional[tuple] = None


# the per-request overridable knobs (subset of decide_kw keys)
_OVERRIDES = ("mode", "use_mmw", "use_simplicial")

# improver-round budget a heuristic_only request falls back to when
# neither the request nor the pool names one — enough rounds for the
# randomized improvers to plateau on the Table-1 instances
DEFAULT_HEURISTIC_ROUNDS = 16

# terminal request states (the value of ``TwScheduler.terminal[rid]``);
# "done" and "timeout" carry a result in ``done[rid]``, "error" carries a
# message in ``errors[rid]``, "cancelled" carries neither
TERMINAL_STATES = ("done", "timeout", "cancelled", "error")


def _round32(n: int) -> int:
    """Word-align the padded vertex count: keeps W stable (bloom parity
    for sub-word instances) and bounds jit signatures."""
    return max(32, -(-n // 32) * 32)


class TwScheduler:
    """Asynchronous continuous-batching scheduler over solve requests.

    Constructor knobs mirror ``solver.solve`` and set the pool defaults;
    each ``submit`` may override the per-request subset (class docstring).
    ``cap=None`` (default) auto-sizes each dispatch's per-lane frontier
    buffer via ``batch.plan_capacity``; ``budget_bytes`` (int or
    ``"auto"``) bounds the whole L-lane pool.  Results per request are
    bit-identical to ``solver.solve(g, ...)`` with the same knobs (see
    DESIGN.md §10/§11 for the two padded-lane caveats inherited from §8).

    Traffic-shaping knobs (DESIGN.md §12): ``max_queue`` bounds the
    admission queue (``QueueFull`` with ``retry_after`` on overflow),
    ``prio_weight`` is the weighted-FIFO anti-starvation ratio, and
    ``pipeline`` the dispatch depth — how many launched rounds may be in
    flight before a ``sync`` is forced (depth 2 keeps the device busy
    across the host-sync gap; discarded speculative rungs keep parity).

    Intra-request scale-out (DESIGN.md §13): ``submit(..., shards=S)``
    admits the request into S pool slots and runs each of its ladder
    rungs as one sharded dispatch (``core.shard.decide_sharded_async``)
    — the frontier split S ways with per-rung work donation, verdicts
    bit-identical to the single-lane ladder.  Slot-proportional
    speculation rides along: holding S slots entitles the request to S
    concurrent rung dispatches per round, so its deepening ladder
    climbs ``max(speculate, shards)`` rungs per round and a heavy
    sharded request finishes in measurably fewer scheduler rounds than
    the same request unsharded (overshoot past the winning rung is
    discarded uncounted — the explicit-``speculate`` semantics).
    ``donate_ratio`` tunes the donation trigger for every sharded
    request in the pool (``None`` =
    ``core.shard.DEFAULT_DONATE_RATIO``).

    Two driving styles:

    * blocking drain — ``run()`` (or repeated ``step()``), as in the
      module example;
    * overlapped — ``launch()`` (admit + enqueue dispatches, returns
      immediately), then host-side work / ``poll_admissions()`` while the
      device flies, then ``sync()`` for the oldest round's verdicts.
      ``step()`` is ``launch(); poll_admissions(); sync()`` with the
      sync skipped while the pipeline still has room.

    ``device`` (default: the card; ``"cpu"`` runs the plain PyTorch ops)
    and ``backend`` (default ``cuda`` on a card, ``torch`` elsewhere)
    pick where every dispatch runs; ``schedule=None`` is ``doubling``,
    the port's closure schedule.

    All public methods take an internal lock, so a persistent front end
    (``repro_torch.launch.twserved``) may ``submit``/``status``/``cancel``
    from server threads while one driver thread steps the pool; the
    device wait in ``sync()`` runs outside the lock, which is what lets
    submissions land *mid-flight*, and event sinks are invoked after the
    lock is released, so a slow sink never stalls dispatch.
    """

    def __init__(self, *, lanes: int = batch.DEFAULT_MAX_LANES,
                 cap: Optional[int] = None, block: int = 1 << 11,
                 mode: str = "sort", use_mmw: bool = False,
                 m_bits: int = 1 << 24, k_hashes: int = bloom.DEFAULT_K,
                 schedule: Optional[str] = None,
                 backend: Optional[str] = None, device=None,
                 use_simplicial: bool = False, use_clique: bool = True,
                 use_paths: bool = True, use_preprocess: bool = True,
                 cap_max: int = batch.DEFAULT_CAP, budget_bytes=None,
                 max_queue: Optional[int] = None, prio_weight: int = 4,
                 pipeline: int = 1, donate_ratio: Optional[float] = None,
                 heuristics: int = 0, seed: int = 0,
                 cache=None,
                 verbose: bool = False, tracker=None):
        self.device = backend_lib.resolve_device(device)
        if backend is None:
            backend = backend_lib.default_backend(self.device)
        if schedule is None:
            schedule = "doubling"
        backend_lib.validate(backend, mode=mode, schedule=schedule,
                             use_mmw=use_mmw, use_simplicial=use_simplicial,
                             m_bits=m_bits, lanes=int(lanes),
                             device=self.device)
        if budget_bytes == "auto":
            budget_bytes = backend_lib.device_memory_budget(
                device=self.device)
        if pipeline < 1:
            raise ValueError(f"pipeline depth must be >= 1 (got {pipeline})")
        # pool-scope telemetry: every dispatch/queue/request counter this
        # scheduler records lands here (and rolls up to the supplied
        # parent / the process root); per-request child scopes hang off
        # this tracker so a request's counters sum exactly into it
        if tracker is None:
            tracker = telemetry.root().child(f"pool{next(_POOL_SEQ)}")
        self.tracker = tracker
        self.pool = SlotPool(int(lanes), max_queue=max_queue,
                             prio_weight=prio_weight,
                             slots_of=lambda r: getattr(r, "shards", 1),
                             tracker=self.tracker)
        self.cap = cap
        self.donate_ratio = donate_ratio
        self.cap_max = cap_max
        self.budget_bytes = budget_bytes
        self.block = block
        self.pipeline = int(pipeline)
        self.verbose = verbose
        self.decide_kw = dict(block=block, mode=mode, use_mmw=use_mmw,
                              m_bits=m_bits, k_hashes=k_hashes,
                              schedule=schedule, backend=backend,
                              use_simplicial=use_simplicial)
        self.plan_kw = dict(use_clique=use_clique, use_paths=use_paths)
        self.use_preprocess = use_preprocess
        # anytime bounds engine (DESIGN.md §15): pool-default improver
        # budget and heuristic seed; per-rid improver rounds launched so
        # far (launch eligibility — the states themselves enforce their
        # own termination)
        self.heuristics = max(0, int(heuristics))
        self.seed = int(seed)
        # content-addressed result cache (DESIGN.md §16): None = off
        # (the library default — unit tests count dispatches), an int =
        # entry bound for a fresh ``ResultCache``, or a caller-owned
        # ``ResultCache`` shared across pools.  ``launch.twserved``
        # defaults it ON for the serving process.
        if isinstance(cache, int):
            cache = ResultCache(cache) if cache > 0 else None
        self.cache = cache
        self._heur_rounds: Dict[int, int] = {}
        self.done: Dict[int, object] = {}       # rid -> solver.SolveResult
        self.errors: Dict[int, str] = {}        # rid -> admission error
        self.terminal: Dict[int, str] = {}      # rid -> TERMINAL_STATES
        # rid -> terminal telemetry snapshot of the request's child scope
        # (taken at the terminal event, then the child is detached — its
        # contributions stay in the pool totals)
        self.req_metrics: Dict[int, dict] = {}
        self.rounds = 0                          # scheduler steps launched
        self.idle_syncs = 0      # syncs that left the device with no round
        self.covered_syncs = 0   # syncs covered by a pipelined next round
        self._next_rid = 0
        self._lock = threading.RLock()
        # FIFO of launched rounds awaiting sync (pipeline depth entries):
        # (round_no, [(handle, metas), ...], t_launch)
        self._rounds: List[tuple] = []
        # rid -> (run object, next k to launch): the pipeline cursor —
        # which ladder rungs of the request's CURRENT block are already
        # in flight, so round N+1 launches the projected next ones
        self._cursor: Dict[int, tuple] = {}
        # rids whose in-flight verdicts must be dropped uncounted
        # (cancelled / deadline-preempted mid-flight)
        self._discard: Set[int] = set()
        # streaming progress per live rid: [lb, ub, seq] (monotone clamps)
        self._prog: Dict[int, list] = {}
        # events buffered under the lock, delivered after release —
        # a slow sink must never stall dispatch (the delivery lock only
        # serializes sink invocation order, reentrantly)
        self._pending: List[tuple] = []
        self._deliver_lock = threading.RLock()
        self._round_s: Optional[float] = None    # EWMA round wall-clock
        # monotone ratchets: padded n (word-aligned, shared) and, per
        # config group, the planned cap — each bump compiles one new
        # program, steady state reuses it
        self._n_pad = 32
        self._cap_pad: Dict[tuple, int] = {}

    # ------------------------------------------------------------ admission

    def submit(self, g: Graph, *, reconstruct: bool = False,
               start_k: Optional[int] = None,
               rid: Optional[int] = None,
               mode: Optional[str] = None,
               use_mmw: Optional[bool] = None,
               use_simplicial: Optional[bool] = None,
               cap: Optional[int] = None,
               speculate: int = 1,
               shards: int = 1,
               priority: int = 0,
               deadline_s: Optional[float] = None,
               on_event: Optional[Callable[[dict], None]] = None,
               heuristics: Optional[int] = None,
               heuristic_only: bool = False,
               seed: Optional[int] = None,
               no_cache: bool = False) -> int:
        """Queue one solve request; returns its request id.

        ``heuristics`` budgets the anytime bounds-improver rounds the
        scheduler interleaves with this request's exact rungs (None =
        pool default; improvements tighten the ladder, never the
        verdict).  ``heuristic_only=True`` skips the exact DP entirely —
        the request is served purely by improver rounds (admission stays
        cheap on graphs beyond exact-DP reach) and terminates with
        ``exact=(lb == ub)``.  ``seed`` pins every heuristic draw so the
        streamed ``bounds`` events are bit-reproducible per request.

        The keyword subset after ``rid`` is the per-request override
        surface (``SolveRequest``).  An override the pool's backend
        cannot run raises ``BackendCapabilityError`` (an invalid explicit
        ``cap`` raises ``ValueError``) *here*, for this request only —
        the pool keeps serving.  ``shards`` > 1 scales the request out
        across that many pool slots (must fit the pool: ``shards`` >
        ``lanes`` raises ``ValueError``).  ``priority`` picks the
        admission class,
        ``deadline_s`` (seconds from now) arms anytime preemption.
        ``no_cache=True`` bypasses the result cache in both directions
        (no lookup, no insertion) when the pool has one.  When
        the admission queue is at ``max_queue`` the submit is rejected
        with ``slots.QueueFull`` carrying a ``retry_after`` hint — the
        backpressure contract.  A ``rid`` colliding with a previously
        issued one raises ``ValueError`` (it would clobber the live or
        finished request's progress).  Thread-safe: a front end may call
        this while a dispatch is in flight; the request is admitted
        during the flight and packed into the next dispatch."""
        deadline = None
        if deadline_s is not None:
            deadline = time.monotonic() + float(deadline_s)
        shards = int(shards)
        if not 1 <= shards <= len(self.pool):
            raise ValueError(
                f"shards={shards} does not fit the pool "
                f"({len(self.pool)} slot(s)); a sharded request needs "
                "shards slots, all from this pool")
        if heuristic_only and shards > 1:
            raise ValueError(
                "heuristic_only=True runs no exact rungs; sharding its "
                "(nonexistent) frontier across slots is meaningless — "
                "drop shards or heuristic_only")
        req = SolveRequest(0, g, reconstruct, start_k, mode=mode,
                           use_mmw=use_mmw, use_simplicial=use_simplicial,
                           cap=cap, speculate=max(1, int(speculate)),
                           shards=shards,
                           priority=int(priority), deadline=deadline,
                           on_event=on_event,
                           heuristics=(None if heuristics is None
                                       else max(0, int(heuristics))),
                           heuristic_only=bool(heuristic_only),
                           seed=None if seed is None else int(seed),
                           no_cache=bool(no_cache))
        kw = self._effective_kw(req)
        backend_lib.validate(kw["backend"], mode=kw["mode"],
                             schedule=kw["schedule"], use_mmw=kw["use_mmw"],
                             use_simplicial=kw["use_simplicial"],
                             m_bits=kw["m_bits"], lanes=len(self.pool),
                             shards=shards, device=self.device)
        if cap is not None:
            engine_lib.validate_geometry(cap, self.block)
        # content-addressed cache key (DESIGN.md §16) — computed OUTSIDE
        # the lock (canonical labeling is pure host work).  heuristic_only
        # requests are excluded: their result depends on the improver
        # round budget actually *consumed*, which is load-dependent.
        ck = cperm = None
        if self.cache is not None and not req.no_cache \
                and not req.heuristic_only and g.n > 0:
            ck, cperm = self._cache_key_for(req)
        with self._lock:
            hit = None
            if ck is not None:
                hit = self.cache.lookup(ck, need_order=req.reconstruct)
            if hit is None and self.pool.max_queue is not None and \
                    self.pool.qsize >= self.pool.max_queue:
                # the lookup above already counted a cache miss; keep the
                # telemetry reconciliation exact even though this request
                # never gets a child scope
                if ck is not None:
                    self.tracker.count(cache_misses=1)
                raise QueueFull(
                    f"admission queue full ({self.pool.qsize} queued, "
                    f"max_queue={self.pool.max_queue})",
                    retry_after=self._retry_after())
            if rid is None:
                rid = self._next_rid
            elif rid < self._next_rid:
                raise ValueError(
                    f"rid {rid} already issued (next fresh rid is "
                    f"{self._next_rid}); duplicate rids would clobber the "
                    "live or finished request")
            self._next_rid = max(self._next_rid, rid) + 1
            req.rid = rid
            req.tracker = self.tracker.child(f"req{rid}")
            req.t_submit = time.monotonic()
            self._prog[rid] = [0, max(0, g.n - 1), 0]
            if hit is not None:
                # warm hit: the request never touches the queue, a lane,
                # or the device — it is resolved right here at submit
                self._serve_cached(req, hit, cperm)
            else:
                if ck is not None:
                    req.cache_key, req.cache_perm = ck, cperm
                    req.tracker.count(cache_misses=1)
                self.pool.submit(req, priority=req.priority)
        # deliver the synthesized hit events (admitted/bounds/done) now —
        # a cached submit returns with the terminal event already sunk
        self._flush_events()
        return rid

    def _retry_after(self) -> float:
        """Backpressure hint: how long until a queue slot plausibly
        frees — the EWMA round wall-clock times the number of admission
        waves the backlog needs to drain through the lane pool."""
        per_round = self._round_s if self._round_s else 1.0
        waves = -(-(self.pool.qsize + 1) // max(1, len(self.pool)))
        return round(max(0.05, per_round * waves), 3)

    def _effective_kw(self, req: SolveRequest) -> dict:
        """Pool defaults with this request's overrides applied."""
        kw = dict(self.decide_kw)
        for f in _OVERRIDES:
            v = getattr(req, f)
            if v is not None:
                kw[f] = v
        return kw

    def _req_seed(self, req: SolveRequest) -> int:
        return self.seed if req.seed is None else req.seed

    def _req_heuristics(self, req: SolveRequest) -> int:
        """Improver-round budget for one request (request override, else
        pool default; a heuristic_only request with neither gets the
        fallback budget — it has no exact ladder to finish it)."""
        n = self.heuristics if req.heuristics is None else req.heuristics
        if req.heuristic_only and n <= 0:
            n = DEFAULT_HEURISTIC_ROUNDS
        return n

    # ------------------------------------------------------- result cache

    def _cache_cfg(self, req: SolveRequest) -> dict:
        """The *effective* solve config that determines the result bits
        for one request — the config half of the content address.  Knobs
        that provably do not change the result (shards, speculate,
        pipeline, priority, deadline: all bit-identical or discarded-
        uncounted paths, DESIGN.md §11–§13) are excluded so differently-
        scheduled resubmissions still hit.  ``seed`` and the heuristics
        budget are always included: ``plan_block`` threads the seed into
        the greedy clique/bound heuristics even at ``heuristics=0``, so
        two seeds can legitimately produce different ``per_k`` surfaces.
        ``reconstruct`` is deliberately *not* keyed — the cache upgrades
        entries toward the order-ful result instead (``lookup`` with
        ``need_order`` misses on order-less entries)."""
        cfg = dict(self._effective_kw(req))
        cfg["cap"] = req.cap if req.cap is not None else self.cap
        cfg["cap_max"] = self.cap_max
        cfg["budget_bytes"] = self.budget_bytes
        cfg["use_preprocess"] = self.use_preprocess
        cfg.update(self.plan_kw)
        cfg["start_k"] = req.start_k
        cfg["heuristics"] = self._req_heuristics(req)
        cfg["seed"] = self._req_seed(req)
        return cfg

    def _cache_key_for(self, req: SolveRequest) -> tuple:
        """(digest, canonical perm) for one request.  ``mode="bloom"``
        results are Monte-Carlo *label-dependent* (the filter hashes
        state bitsets), so bloom keys address the as-submitted adjacency
        (identity perm) — only bit-identical resubmissions hit; every
        exact-dedup mode keys the canonical form, so any isomorphic
        relabeling hits."""
        cfg = self._cache_cfg(req)
        return canon.cache_key(req.g, cfg,
                               canonical=(cfg["mode"] != "bloom"))

    def _serve_cached(self, req: SolveRequest, res, perm) -> None:
        """Resolve one request from a cache hit, at submit time, under
        the scheduler lock.  The synthesized event stream (``admitted``
        flagged ``cached``, one ``bounds``, terminal ``done``) satisfies
        every invariant of the live stream — same shape, same monotone
        clamps, strictly increasing ``seq`` — so sinks cannot tell a hit
        from an instant solve except by the flag.  The stored order is
        canonical-space; it is translated back through the *hitting*
        submission's perm, so a relabeled duplicate receives an order
        valid for its own labels."""
        rid = req.rid
        if res.order is not None:
            if req.reconstruct:
                inv = [0] * len(perm)
                for v, c in enumerate(perm):
                    inv[c] = v
                res = dataclasses.replace(
                    res, order=[inv[c] for c in res.order])
            else:
                # a non-reconstruct submission must see the same surface
                # as its own uncached solve: no order
                res = dataclasses.replace(res, order=None)
        self._emit(req, {"event": "admitted", "name": req.g.name,
                         "round": self.rounds + 1, "cached": True})
        req.round_admitted = self.rounds
        req.tracker.timing("admission_s", time.monotonic() - req.t_submit)
        req.tracker.count(cache_hits=1)
        prog = self._prog[rid]
        lb = max(prog[0], res.width if res.exact else res.lb)
        ub = min(prog[1], res.width)
        prog[0], prog[1] = lb, ub
        self._emit(req, {"event": "bounds", "lb": lb, "ub": ub,
                         "cached": True})
        self.done[rid] = res
        self.terminal[rid] = "done"
        self.tracker.count(reqs_done=1)
        snap = self._close_request(req)
        prog = self._prog.pop(rid)
        self._emit(req, {"event": "done", "width": res.width,
                         "exact": res.exact, "lb": lb, "ub": res.width,
                         "expanded": res.expanded, "rounds": self.rounds,
                         "cached": True, "metrics": snap},
                   prog=prog)
        if self.verbose:
            print(f"[twserve] req {rid} ({req.g.name}): cache hit, "
                  f"width={res.width} exact={res.exact}", flush=True)

    def cache_stats(self) -> dict:
        """Result-cache counters (``enabled: False`` when the pool runs
        without one); the front end's ``cache_stats`` wire op returns
        exactly this dict."""
        if self.cache is None:
            return {"enabled": False}
        return dict(self.cache.stats(), enabled=True)

    def _group_key(self, req: SolveRequest) -> tuple:
        """Requests share a vmapped program iff this key matches: the
        static decide config plus the cap setting (explicit caps pin the
        jit signature; ``None`` caps share the planned ratchet)."""
        kw = self._effective_kw(req)
        return tuple(sorted(kw.items())) + (("cap", req.cap),)

    def _start(self, req: SolveRequest):
        """Admission: build the request's deepening state (preprocess +
        bounds + first block plan — host-only work, safe to overlap with
        an in-flight dispatch).  Returns None when the request does not
        take a lane: trivial instance (decided at admission), deadline
        already expired (anytime-resolved), or admission failure
        (``error`` terminal event — the failure is isolated to this
        request; the queue keeps admitting)."""
        try:
            self._emit(req, {"event": "admitted", "name": req.g.name,
                             "round": self.rounds + 1})
            req.round_admitted = self.rounds
            # the queue wait alone: the planning below is timed by its
            # own spans (``preprocess_s``, ``plan_s``) in the request's
            # scope, through ``InstanceState``'s tracker
            if req.tracker is not None and req.t_submit:
                req.tracker.timing("admission_s",
                                   time.monotonic() - req.t_submit)
            if req.deadline is not None and \
                    time.monotonic() >= req.deadline:
                # expired while queued: resolve with what is known now
                # (nothing ran, so the trivial 0..n-1 bounds clamped by
                # any prior stream state)
                prog = self._prog.get(req.rid) or [0, max(0, req.g.n - 1),
                                                   0]
                res = solver_lib.SolveResult(prog[1], False, prog[0],
                                             prog[1], 0, 0.0, None, {})
                self._resolve_timeout(req, res)
                return None
            if req.heuristic_only:
                # bounds-only serving: no preprocess, no block plans, no
                # exact rungs — just the improver lanes (DESIGN.md §15)
                inst = bounds_engine.HeuristicState(
                    req.g, solver_lib, seed=self._req_seed(req),
                    max_rounds=self._req_heuristics(req),
                    tracker=req.tracker)
            else:
                inst = batch.InstanceState(
                    req.g, solver_lib, use_preprocess=self.use_preprocess,
                    plan_kw=dict(start_k=req.start_k,
                                 seed=self._req_seed(req),
                                 device=self.device, **self.plan_kw),
                    reconstruct=req.reconstruct,
                    recon_kw=self._recon_kw(req), tracker=req.tracker)
        except Exception as e:    # noqa: BLE001 — per-request isolation
            self._fail(req, e)
            return None
        if inst.result is not None:
            self._finish(req, inst)
            return None
        self._emit(req, dict(self._bounds_event(req, inst),
                             event="bounds"))
        return (req, inst)

    def _recon_kw(self, req: SolveRequest) -> dict:
        return dict(cap=req.cap if req.cap is not None else self.cap,
                    cap_max=self.cap_max, device=self.device,
                    **self._effective_kw(req))

    def _close_request(self, req: SolveRequest) -> Optional[dict]:
        """Terminal telemetry: stamp the rounds-per-request gauge, take
        the request child scope's final snapshot (retained in
        ``req_metrics`` and attached to the terminal event), then detach
        the child — its counts stay in the pool totals (write-through),
        so a drained pool's request snapshots still sum to the pool
        scope.  Returns None when the request never got a child scope
        (e.g. a hand-built ``SolveRequest`` fed straight to the pool)."""
        self._heur_rounds.pop(req.rid, None)
        tr = req.tracker
        if tr is None or isinstance(tr, telemetry.NullTracker):
            return None
        tr.gauge("rounds", max(0, self.rounds - req.round_admitted))
        if req.t_submit:
            # submit -> terminal latency: what an open-loop load driver
            # reads its percentiles from (benchmarks/serve_load.py)
            tr.timing("request_s", time.monotonic() - req.t_submit)
        snap = tr.snapshot()
        self.req_metrics[req.rid] = snap
        self.tracker.drop_child(f"req{req.rid}")
        return snap

    def _finish(self, req: SolveRequest, inst: batch.InstanceState):
        r = inst.result
        self.done[req.rid] = r
        self.terminal[req.rid] = "done"
        self.tracker.count(reqs_done=1)
        # the ONE cache-insertion point (DESIGN.md §16): only a clean
        # ``done`` populates the cache — cancel, deadline and error take
        # different terminal paths and never reach here.  ``cache_key``
        # was stamped at submit iff this request is cacheable.
        if self.cache is not None and req.cache_key is not None:
            store = r
            if r.order is not None and req.cache_perm:
                # store the order in canonical label space, so the entry
                # serves every isomorphic relabeling of this graph
                store = dataclasses.replace(
                    r, order=[req.cache_perm[v] for v in r.order])
            evicted = self.cache.insert(req.cache_key, store)
            self.tracker.count(cache_insertions=1)
            if evicted:
                self.tracker.count(cache_evictions=evicted)
        snap = self._close_request(req)
        prog = self._prog.pop(req.rid, [0, max(0, req.g.n - 1), 0])
        lb = max(prog[0], r.width if r.exact else r.lb)
        self._emit(req, {"event": "done", "width": r.width,
                         "exact": r.exact, "lb": lb, "ub": r.width,
                         "expanded": r.expanded, "rounds": self.rounds,
                         "metrics": snap},
                   prog=prog)
        if self.verbose:
            print(f"[twserve] req {req.rid} ({req.g.name}): width={r.width}"
                  f" exact={r.exact} expanded={r.expanded}", flush=True)

    def _fail(self, req: SolveRequest, err: Exception):
        """Admission failed for this request alone: record the error,
        emit the ``error`` terminal event, keep the pool serving."""
        msg = f"{type(err).__name__}: {err}"
        self.errors[req.rid] = msg
        self.terminal[req.rid] = "error"
        self.tracker.count(reqs_error=1)
        snap = self._close_request(req)
        prog = self._prog.pop(req.rid, [0, 0, 0])
        self._emit(req, {"event": "error", "error": msg, "metrics": snap},
                   prog=prog)
        if self.verbose:
            print(f"[twserve] req {req.rid} ({getattr(req.g, 'name', '?')})"
                  f" failed at admission: {msg}", flush=True)

    def _resolve_timeout(self, req: SolveRequest, res):
        """Terminal path for deadline expiry: the anytime result (monotone
        best-so-far lb/ub, ``exact=False``) plus a ``done`` event flagged
        ``timed_out`` — a timed-out request returns bounds, not nothing."""
        self.done[req.rid] = res
        self.terminal[req.rid] = "timeout"
        self.tracker.count(reqs_timeout=1)
        snap = self._close_request(req)
        prog = self._prog.pop(req.rid, [res.lb, res.ub, 0])
        self._emit(req, {"event": "done", "width": res.width,
                         "exact": False, "timed_out": True, "lb": res.lb,
                         "ub": res.ub, "expanded": res.expanded,
                         "rounds": self.rounds, "metrics": snap},
                   prog=prog)
        if self.verbose:
            print(f"[twserve] req {req.rid} ({req.g.name}): deadline "
                  f"expired, anytime lb={res.lb} ub={res.ub}", flush=True)

    # ------------------------------------------------------ traffic shaping

    def cancel(self, rid: int) -> bool:
        """Abandon one request: a queued rid is dropped from the queue, a
        running rid frees its lane immediately (mid-ladder) and any
        in-flight verdicts for it are discarded uncounted at the next
        ``sync``.  Emits the terminal ``cancelled`` event (carrying the
        last streamed lb/ub).  Returns True when something was cancelled;
        False for unknown or already-terminal rids (idempotent)."""
        with self._lock:
            ok = False
            if rid not in self.terminal:
                req = self.pool.discard(lambda r: r.rid == rid)
                if req is None:
                    for i, (r, _inst) in self.pool.active():
                        if r.rid == rid:
                            req = r
                            self.pool.release(i)     # the lane frees NOW
                            self._cursor.pop(rid, None)
                            self._discard.add(rid)   # in-flight verdicts
                            break
                if req is not None:
                    self.terminal[rid] = "cancelled"
                    self.tracker.count(reqs_cancelled=1)
                    snap = self._close_request(req)
                    prog = self._prog.pop(rid, [0, 0, 0])
                    self._emit(req, {"event": "cancelled", "lb": prog[0],
                                     "ub": prog[1], "rounds": self.rounds,
                                     "metrics": snap},
                               prog=prog)
                    ok = True
                    if self.verbose:
                        print(f"[twserve] req {rid} cancelled", flush=True)
        self._flush_events()
        return ok

    def _expire_deadlines(self):
        """Deadline sweep (under the lock, at sync time): preempt every
        lane whose request ran past its deadline — resolve it with the
        anytime bounds, free the lane, and mark any still-in-flight rungs
        for uncounted discard."""
        now = time.monotonic()
        for i, (req, inst) in self.pool.active():
            if req.deadline is None or now < req.deadline:
                continue
            b = self._bounds_event(req, inst)
            self._resolve_timeout(
                req, inst.anytime_result(lb=b["lb"], ub=b["ub"]))
            self.pool.release(i)
            self._cursor.pop(req.rid, None)
            self._discard.add(req.rid)

    # ------------------------------------------------------------ streaming

    def _emit(self, req: SolveRequest, ev: dict,
              prog: Optional[list] = None):
        """Buffer one event for the request's callback.  The ``seq``
        stamp is taken under the scheduler lock (ordering guarantees);
        delivery happens in ``_flush_events`` *after* the lock is
        released, so a slow or blocking sink never stalls dispatch."""
        if req.on_event is None:
            return
        if prog is None:
            prog = self._prog.get(req.rid)
        seq = 0
        if prog is not None:
            prog[2] += 1
            seq = prog[2]
        self._pending.append((req.on_event, req.rid, dict(ev, rid=req.rid,
                                                          seq=seq)))

    def _flush_events(self):
        """Deliver buffered events outside the scheduler lock.  The
        delivery lock (reentrant) serializes concurrent flushers so the
        global emission order is preserved; a raising sink is isolated
        (warn + drop), never failing the solve."""
        if not self._pending:
            return
        with self._deliver_lock:
            with self._lock:
                pending, self._pending = self._pending, []
            for cb, rid, ev in pending:
                try:
                    cb(ev)
                except Exception as e:   # noqa: BLE001 — sink isolation
                    warnings.warn(f"twserve event sink for rid {rid} "
                                  f"raised {e!r}; event dropped",
                                  stacklevel=2)

    def _bounds_event(self, req: SolveRequest, inst) -> dict:
        """Running instance-level (lb, ub) — ``InstanceState.bounds``
        clamped monotone against the previously streamed pair."""
        lb, ub = inst.bounds()
        prog = self._prog.get(req.rid)
        if prog is not None:
            lb = max(lb, prog[0])
            ub = min(ub, prog[1])
            prog[0], prog[1] = lb, ub
        return {"lb": lb, "ub": ub}

    def status(self, rid: int) -> dict:
        """Queued / running / terminal snapshot for one request
        (thread-safe; the front end's ``status`` endpoint).  Terminal
        states: ``done`` (with ``timed_out: true`` when a deadline
        preempted it), ``cancelled``, ``error``."""
        with self._lock:
            t = self.terminal.get(rid)
            if t == "cancelled":
                return {"state": "cancelled"}
            if t == "error":
                return {"state": "error",
                        "error": self.errors.get(rid, "admission failed")}
            if rid in self.done:
                r = self.done[rid]
                st = {"state": "done", "width": r.width, "exact": r.exact,
                      "lb": r.lb, "ub": r.ub, "expanded": r.expanded}
                if t == "timeout":
                    st["timed_out"] = True
                return st
            for _i, (req, inst) in self.pool.active():
                if req.rid == rid:
                    return dict(self._bounds_event(req, inst),
                                state="running")
            if any(req.rid == rid for req in self.pool.queued()):
                return {"state": "queued"}
            return {"state": "unknown"}

    def metrics(self, rid: Optional[int] = None) -> dict:
        """Scoped telemetry snapshot (thread-safe): the pool scope's
        totals plus per-request snapshots — live and queued requests
        snapshotted in place, finished ones from the snapshot retained
        at their terminal event.  With ``rid`` only that request is
        included (empty ``requests`` for unknown rids).  Because request
        child scopes write through to the pool scope, the rung-level
        counters of the ``requests`` snapshots sum exactly into
        ``pool["counters"]``; the front end's ``metrics`` wire op
        returns exactly this dict."""
        with self._lock:
            requests = dict(self.req_metrics)
            live = list(self.pool.queued()) + \
                [req for _i, (req, _inst) in self.pool.active()]
            for req in live:
                tr = req.tracker
                if tr is not None and \
                        not isinstance(tr, telemetry.NullTracker):
                    requests[req.rid] = tr.snapshot()
            if rid is not None:
                requests = {rid: requests[rid]} if rid in requests else {}
            return {"pool": self.tracker.snapshot(children=False),
                    "rounds": self.rounds, "queued": self.pool.qsize,
                    "idle_syncs": self.idle_syncs,
                    "covered_syncs": self.covered_syncs,
                    "requests": requests}

    # ----------------------------------------------------------- the engine

    def launch(self) -> bool:
        """Admit, pack every occupied lane's next rung(s), and enqueue
        the dispatches **without waiting for their verdicts** (the
        handles are held in flight; the port's dispatches have run their
        rung by the time they return, so the overlap is at rung
        boundaries).  With ``pipeline > 1``
        a lane's next rungs are its *projected* ladder steps (the
        pipeline cursor): the rungs after the ones already in flight for
        its current block — launched before the previous round syncs, so
        the device never drains.  Returns False when nothing was packed
        (idle pool, or every ladder fully in flight)."""
        with self._lock:
            if len(self._rounds) >= self.pipeline:
                raise RuntimeError(
                    f"launch() with {len(self._rounds)} round(s) in "
                    f"flight (pipeline depth {self.pipeline}); sync() "
                    "first")
            self.pool.admit(self._start)
            # low-priority improver lanes ride along with the exact rungs:
            # one batched dispatch covers every request with budget left
            heur = self._pack_improvers()
            members = []          # (slot, req, inst, run, [ks to launch])
            for i, (req, inst) in self.pool.active():
                run = inst.run
                if run is None:
                    continue      # heuristic_only: improver lanes only
                cur = self._cursor.get(req.rid)
                # a heuristic lb jump may have moved run.k past the
                # cursor: rungs below run.k are already refuted, never
                # re-launch them
                k0 = max(cur[1], run.k) \
                    if (cur is not None and cur[0] is run) else run.k
                # slot-proportional speculation: a width-S request holds
                # S slots, so it is entitled to S concurrent rung
                # dispatches per round — its ladder climbs S rungs per
                # round (each rung an S-way sharded dispatch), which is
                # what lets a sharded heavy request finish in fewer
                # scheduler rounds (overshoot past the winning rung is
                # discarded uncounted, same as explicit speculation)
                win = max(req.speculate, req.shards)
                hi = min(k0 + win, run.plan.ub)
                if k0 >= hi:
                    continue      # whole remaining ladder already flying
                members.append((i, req, inst, run, list(range(k0, hi))))
                self._cursor[req.rid] = (run, hi)
            if not members and not heur:
                launched = False
            else:
                launched = True
                self.rounds += 1
                if members:
                    n_round = max(run.plan.g.n
                                  for _i, _r, _s, run, _ks in members)
                    self._n_pad = max(self._n_pad, _round32(n_round))
                L = len(self.pool)

                groups: Dict[tuple, tuple] = {}
                sharded = []    # one (i, req, inst, run, kk, name) per rung
                for i, req, inst, run, ks in members:
                    if req.shards > 1:
                        # scale-out request: each rung is its own sharded
                        # dispatch (frontier split req.shards ways), not a
                        # lane of the shared vmapped group
                        for kk in ks:
                            sharded.append((i, req, inst, run, kk,
                                            run.plan.g.name))
                            self._emit(req, {"event": "rung_started",
                                             "block": run.plan.g.name,
                                             "k": kk, "round": self.rounds})
                        continue
                    lanes, metas = groups.setdefault(self._group_key(req),
                                                     ([], []))
                    for kk in ks:
                        lanes.append(batch.Lane(run.plan.graph_at(kk), kk,
                                                tuple(run.plan.clique)))
                        metas.append((i, req, inst, run, kk,
                                      run.plan.g.name))
                        self._emit(req, {"event": "rung_started",
                                         "block": run.plan.g.name,
                                         "k": kk, "round": self.rounds})
                # every dispatch resident before any sync — including the
                # pipelined rounds still in flight — splits the budget
                n_dispatch = sum(len(hs) for _no, hs, _t in self._rounds)
                n_dispatch += sum(-(-len(lanes) // L)
                                  for lanes, _m in groups.values())
                n_dispatch += len(sharded)

                handles = []
                for key, (lanes, metas) in groups.items():
                    kw = dict(key)
                    cap = kw.pop("cap")
                    if cap is None:
                        cap = self.cap
                    if cap is None:
                        cap = self._plan_group_cap(key, lanes, n_dispatch)
                    # chunk a speculation-widened group into pool-sized
                    # dispatches (lane axis padded to the full pool so
                    # the steady state reuses one compiled program)
                    for lo in range(0, len(lanes), L):
                        # a shared vmapped dispatch serves many requests,
                        # so its dispatch/host-sync counts are pool-level
                        # (the per-rung expanded counts are attributed to
                        # requests at feed time, via InstanceState)
                        handle = batch.decide_lanes_async(
                            lanes[lo:lo + L], cap=cap, n_pad=self._n_pad,
                            lane_pad=L, tracker=self.tracker,
                            device=self.device, **kw)
                        handles.append((handle, metas[lo:lo + L]))
                for meta in sharded:
                    i, req, inst, run, kk, name = meta
                    kw = self._effective_kw(req)
                    cap = req.cap if req.cap is not None else self.cap
                    if cap is None:
                        key = ("shard", req.shards) + self._group_key(req)
                        cap = self._plan_group_cap(
                            key,
                            [batch.Lane(run.plan.graph_at(kk), kk,
                                        tuple(run.plan.clique))],
                            n_dispatch, width=req.shards)
                    # a sharded dispatch runs one request's rung alone, so
                    # its dispatch count and donation/occupancy stats are
                    # attributable — they land in the request's child
                    # scope and roll up to the pool totals
                    handle = shard_lib.decide_sharded_async(
                        run.plan.graph_at(kk), kk, tuple(run.plan.clique),
                        shards=req.shards, cap=cap, n_pad=self._n_pad,
                        donate_ratio=self.donate_ratio,
                        tracker=req.tracker or self.tracker,
                        device=self.device, **kw)
                    # one-element metas: the handle finalizes to a single
                    # LaneResult, so sync()'s zip feeds it like any lane
                    handles.append((handle, [meta]))
                if heur:
                    # ONE vmapped dispatch improves every budgeted
                    # request's ub (seeded randomized min-degree sweep);
                    # the matching lb contraction runs host-side at apply
                    # time.  Metas are tagged "heur" so sync() routes
                    # them through _apply_improvement, not feed
                    handle = bounds_engine.ub_orders_async(
                        [g for _i, _r, _s, _run, g, _sd in heur],
                        [sd for _i, _r, _s, _run, _g, sd in heur],
                        tracker=self.tracker, device=self.device)
                    handles.append((handle,
                                    [("heur", i, req, inst, run, sd)
                                     for i, req, inst, run, _g, sd
                                     in heur]))
                self._rounds.append((self.rounds, handles,
                                     time.monotonic()))
        self._flush_events()
        return launched

    def _plan_group_cap(self, key: tuple, lanes: list,
                        n_dispatch: int = 1,
                        width: Optional[int] = None) -> int:
        """plan_capacity for one config group, ratcheted per group key
        (compile stability) and re-clamped whenever the budget share
        shrinks — because the padded word count grew, or because the
        step launches several concurrent dispatches (``n_dispatch``)
        that split ``budget_bytes`` between them.  ``width`` is the
        dispatch's resident lane count — the full pool for a shared
        vmapped group (default), ``req.shards`` for a sharded dispatch
        whose per-shard buffers are what the plan sizes."""
        if width is None:
            width = len(self.pool)
        budget = self.budget_bytes
        if budget is not None:
            budget = int(budget) // max(1, n_dispatch)
        w = bitset.n_words(self._n_pad)
        cap = max(batch.plan_capacity(
            lane.g.n, w, lanes=width, block=self.block,
            cap_max=self.cap_max, budget_bytes=budget)
            for lane in lanes)
        cap = max(self._cap_pad.get(key, 0), cap)
        if budget is not None:
            # the budget outranks the compile-stability ratchet: a cap
            # ratcheted under a smaller word count (or a
            # fewer-dispatches step) must shrink, or the resident pools
            # would exceed the bytes the knob promises to bound
            afford = int(budget) // (width * 4 * max(1, w))
            cap = min(cap, max(32, batch._pow2_floor(afford)))
        self._cap_pad[key] = cap
        return cap

    def _pack_improvers(self) -> list:
        """Collect this round's anytime-improver lanes (under the lock):
        every active request with improver budget left and an open
        lb < ub gap contributes its *current* graph — the in-flight
        block for an exact request (block-local bounds compose through
        ``InstanceState.bounds``), the whole graph for heuristic_only.
        Returns ``(slot, req, inst, run, graph, seed)`` tuples; the seed
        is derived from the request seed and the round index, so the
        improver stream is deterministic per request."""
        out = []
        for i, (req, inst) in self.pool.active():
            budget = self._req_heuristics(req)
            done = self._heur_rounds.get(req.rid, 0)
            if done >= budget:
                continue
            lb, ub = inst.bounds()
            if lb >= ub:
                continue
            run = inst.run
            target = run.plan.g if run is not None else inst.g
            seed = bounds_engine._round_seed(self._req_seed(req), done)
            self._heur_rounds[req.rid] = done + 1
            out.append((i, req, inst, run, target, seed))
        return out

    def _apply_improvement(self, i: int, req: SolveRequest, inst,
                           run, seed: int, width: int, order: list):
        """Sync-side half of one improver round (under the lock): pair
        the dispatched ub sweep with a host lb contraction, clamp both
        into the request's state (``improve_bounds`` — monotone tighten
        only), emit a ``bounds`` event if either side moved, and resolve
        the request if the bounds closed its remaining ladder.  Stale
        results (the block advanced, the request went terminal) are
        dropped — improvements for a graph no longer being solved prove
        nothing about the current block."""
        rid = req.rid
        if rid in self._discard or rid in self.terminal or \
                inst.result is not None or inst.run is not run:
            return
        target = run.plan.g if run is not None else inst.g
        lb_new = bounds_engine.contraction_lb(target, seed)
        prog = self._prog.get(rid)
        before = (prog[0], prog[1]) if prog is not None else None
        info = inst.improve_bounds(lb=lb_new, ub=width, ub_order=order)
        counts = {}
        if info["ub_improved"]:
            counts["heur_ub_improvements"] = 1
        if info["lb_improved"]:
            counts["heur_lb_improvements"] = 1
        if info["rungs_skipped"]:
            counts["exact_rungs_skipped"] = info["rungs_skipped"]
        if counts:
            (req.tracker or self.tracker).count(**counts)
        b = self._bounds_event(req, inst)
        if before is None or (b["lb"], b["ub"]) != before:
            self._emit(req, dict(b, event="bounds", round=self.rounds))
        if req.heuristic_only:
            inst.step_done()     # budget accounting lives in the state
        if inst.result is not None:
            self._finish(req, inst)
            self.pool.release(i)
            self._cursor.pop(rid, None)

    def poll_admissions(self) -> None:
        """Overlap bookkeeping: admit and plan newly arrived requests
        into free slots while the launched dispatches are still in
        flight.  Touches host state only (queue, slots, preprocessing/
        bounds of the new requests) — never the in-flight device buffers
        (DESIGN.md §11's overlap invariant); the admitted requests join
        the next ``launch()``."""
        with self._lock:
            self.pool.admit(self._start)
        self._flush_events()

    def sync(self) -> bool:
        """Block for the *oldest* in-flight round's verdicts, feed them
        through each request's ``InstanceState`` in rung order, emit
        ``rung_decided`` events, recycle finished slots, and run the
        deadline sweep.  Verdicts for a cancelled rid, or for a rung of
        a block that already decided (pipelining/speculation overshoot),
        are discarded uncounted — the sequential ladder never ran them.
        The device wait runs outside the scheduler lock so submissions,
        ``status`` and ``cancel`` calls keep landing mid-flight.
        Returns False when nothing was in flight."""
        with self._lock:
            if not self._rounds:
                return False
            no, parts, t_launch = self._rounds.pop(0)
        for handle, metas in parts:
            results = handle.result()          # device wait — no lock held
            with self._lock:
                if metas and metas[0][0] == "heur":
                    # improver lanes: apply, don't feed (bounds can move
                    # and rungs can be skipped, but no rung is counted)
                    for (_t, i, req, inst, run, seed), (w, order) in \
                            zip(metas, results):
                        self._apply_improvement(i, req, inst, run, seed,
                                                w, order)
                    continue
                for (i, req, inst, run, k, name), res in zip(metas,
                                                             results):
                    if req.rid in self._discard or inst.run is not run \
                            or k != run.k:
                        # cancelled, deadline-preempted, the block
                        # decided on an earlier rung, or a heuristic lb
                        # jump skipped past this rung: the (tightened)
                        # sequential ladder never ran it — discard
                        # uncounted (speculation semantics, §8)
                        continue
                    inst.feed(k, res)
                    self._emit(req, dict(
                        self._bounds_event(req, inst),
                        event="rung_decided", block=name, k=k,
                        round=no, feasible=res.feasible,
                        inexact=res.inexact, expanded=res.expanded))
                    if inst.result is not None:
                        self._finish(req, inst)
                        self.pool.release(i)
                        self._cursor.pop(req.rid, None)
        with self._lock:
            self._expire_deadlines()
            dt = time.monotonic() - t_launch
            self._round_s = dt if self._round_s is None else \
                0.7 * self._round_s + 0.3 * dt
            self.tracker.timing("round_s", dt)
            if self._rounds:
                self.covered_syncs += 1    # the device already has work
            else:
                self.idle_syncs += 1       # host-sync gap: device idles
                self._discard.clear()      # nothing in flight references
        self._flush_events()
        return True

    def step(self) -> bool:
        """One overlapped scheduler step: launch the next round's shared
        dispatches, run admission/planning for new arrivals while the
        device works, then — once the pipeline is full (or nothing new
        launched) — sync the oldest round's verdicts and recycle slots.
        With ``pipeline=1`` this is exactly launch → poll → sync; deeper
        pipelines keep ``pipeline`` rounds in flight so the device stays
        busy across each host sync."""
        launched = False
        if len(self._rounds) < self.pipeline:
            launched = self.launch()
        self.poll_admissions()
        if self._rounds and (len(self._rounds) >= self.pipeline
                             or not launched):
            self.sync()
            return True
        return launched

    def recover(self) -> None:
        """Cleanup after a raised ``step()`` — a persistent driver must
        keep driving.  Discards every in-flight round *and resets the
        pipeline cursors*: a failed ``sync`` already lost its round's
        verdicts, so feeding any younger pipelined round (or launching
        from a cursor past the lost rungs) would leave a gap in the
        deepening ladder and break parity.  The next ``launch()``
        re-packs each lane from its unchanged host state
        (``InstanceState`` only advances in ``feed``, so nothing is lost
        or double-counted — the discarded rungs simply re-run)."""
        with self._lock:
            for _no, handles, _t in self._rounds:
                for handle, metas in handles:
                    if handle is not None:
                        handle.discard()
                    if metas and metas[0][0] == "heur":
                        # un-spend the discarded improver rounds, or a
                        # heuristic_only request whose budget was burned
                        # by a failed round could never terminate
                        for _t_, _i, req, _inst, _run, _sd in metas:
                            n = self._heur_rounds.get(req.rid, 0)
                            if n > 0:
                                self._heur_rounds[req.rid] = n - 1
            self._rounds = []
            self._cursor.clear()
        self._flush_events()

    def run(self, max_rounds: int = 1_000_000) -> Dict[int, object]:
        """Drain the queue (and the pipeline); returns
        {rid: solver.SolveResult} for completed and deadline-resolved
        requests (cancelled/errored rids carry no result — see
        ``terminal``/``errors``)."""
        rounds = 0
        while (self.pool.busy or self.in_flight) and rounds < max_rounds:
            if not self.step():
                break
            rounds += 1
        self._flush_events()
        return self.done

    @property
    def in_flight(self) -> bool:
        """Is a launched dispatch awaiting ``sync()``?"""
        return bool(self._rounds)

    @property
    def inflight_dispatches(self) -> int:
        """Dispatches currently resident on device across the pipeline."""
        return sum(len(handles) for _no, handles, _t in self._rounds)

    def pool_bytes(self) -> int:
        """Resident frontier-pool footprint of the largest dispatch issued
        so far (lanes x cap x W uint32 rows — ``frontier.frontier_bytes``)."""
        cap = self.cap
        if cap is None:
            cap = max(self._cap_pad.values(), default=0) or \
                batch.plan_capacity(self._n_pad, block=self.block,
                                    cap_max=self.cap_max)
        return frontier_lib.frontier_bytes(cap, bitset.n_words(self._n_pad),
                                           lanes=len(self.pool))
