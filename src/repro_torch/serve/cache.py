"""Bounded content-addressed result cache with an LRU+pin policy.

Entries are keyed by ``core.canon.cache_key`` digests (canonical graph ×
effective solve config) and hold a finished :class:`SolveResult` plus the
elimination order in *canonical* label space (the scheduler translates
through the submission's canonical permutation on insert and hit, so one
entry serves every isomorphic relabeling).

Policy: plain LRU over unpinned entries, with ``pin``/``unpin`` taking
entries out of eviction consideration (for instances an operator wants
resident — e.g. the Table 1 suite during a benchmark run).  Pins are
honored over capacity: if every entry is pinned the cache grows past
``entries`` rather than evicting a pinned result; eviction resumes once
unpinned entries exist.  All operations are O(1) and thread-safe — the
scheduler calls ``lookup`` on its submit path under client threads and
``insert`` from the driver thread.

The cache never stores in-flight or failed work: the scheduler inserts
only on a clean ``done`` (DESIGN.md §16), so a ``lookup`` hit is always a
complete, replay-verified result.

A copy of ``repro.serve.cache`` over the port's ``solver.SolveResult``,
so that the PyTorch port never imports ``repro``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Dict, Optional

from ..core.solver import SolveResult


@dataclass
class CacheEntry:
    """One finished solve: the result plus its canonical-space order."""
    result: SolveResult                 # order field is canonical-space
    pinned: bool = False
    hits: int = 0


def _copy_result(r: SolveResult) -> SolveResult:
    """Deep-enough copy: callers mutate neither the cache's result nor
    each other's (per_k dicts and order lists are fresh objects)."""
    return replace(
        r,
        order=None if r.order is None else list(r.order),
        per_k=None if r.per_k is None else dict(r.per_k),
    )


class ResultCache:
    """LRU+pin cache mapping content digests to finished SolveResults."""

    def __init__(self, entries: int = 256):
        if entries < 1:
            raise ValueError(f"cache needs entries >= 1, got {entries}")
        self.capacity = int(entries)
        self._lock = threading.Lock()
        self._d: "OrderedDict[str, CacheEntry]" = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._insertions = 0
        self._evictions = 0

    # ------------------------------------------------------------- lookups
    def lookup(self, key: str, need_order: bool = False) -> Optional[SolveResult]:
        """Return a private copy of the cached result, or None.

        ``need_order=True`` (a ``reconstruct`` submission) misses on
        entries solved without reconstruction — the scheduler then runs
        the solve and the order-ful result overwrites the entry, so the
        cache monotonically upgrades toward the richer surface."""
        with self._lock:
            e = self._d.get(key)
            if e is None or (need_order and e.result.order is None):
                self._misses += 1
                return None
            self._d.move_to_end(key)
            self._hits += 1
            e.hits += 1
            return _copy_result(e.result)

    def peek(self, key: str) -> Optional[SolveResult]:
        """lookup without touching recency or hit/miss accounting."""
        with self._lock:
            e = self._d.get(key)
            return None if e is None else _copy_result(e.result)

    # ------------------------------------------------------------- updates
    def insert(self, key: str, result: SolveResult) -> int:
        """Store ``result`` under ``key``; returns evictions performed.

        Overwrites an existing entry only when the newcomer is at least
        as rich (has an order when the incumbent does) — a plain re-solve
        must not downgrade an order-ful entry to an order-less one."""
        with self._lock:
            e = self._d.get(key)
            if e is not None:
                if e.result.order is not None and result.order is None:
                    self._d.move_to_end(key)
                    return 0
                e.result = _copy_result(result)
                self._d.move_to_end(key)
                self._insertions += 1
                return 0
            self._d[key] = CacheEntry(result=_copy_result(result))
            self._insertions += 1
            evicted = 0
            if len(self._d) > self.capacity:
                # scan oldest-first for unpinned victims; pinned entries
                # are skipped, which can legitimately leave the cache
                # over capacity
                for k in list(self._d):
                    if len(self._d) <= self.capacity:
                        break
                    if self._d[k].pinned or k == key:
                        continue
                    del self._d[k]
                    evicted += 1
            self._evictions += evicted
            return evicted

    def pin(self, key: str) -> bool:
        with self._lock:
            e = self._d.get(key)
            if e is None:
                return False
            e.pinned = True
            return True

    def unpin(self, key: str) -> bool:
        with self._lock:
            e = self._d.get(key)
            if e is None:
                return False
            e.pinned = False
            return True

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    # --------------------------------------------------------------- intro
    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._d

    def stats(self) -> Dict[str, object]:
        """Counters for the ``cache_stats`` wire op and telemetry
        reconciliation: hits + misses == lookups, insertions - evictions
        == entries (absent overwrites), hit_rate over all lookups."""
        with self._lock:
            lookups = self._hits + self._misses
            return {
                "entries": len(self._d),
                "capacity": self.capacity,
                "pinned": sum(1 for e in self._d.values() if e.pinned),
                "hits": self._hits,
                "misses": self._misses,
                "insertions": self._insertions,
                "evictions": self._evictions,
                "hit_rate": (self._hits / lookups) if lookups else 0.0,
            }
