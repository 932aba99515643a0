"""Fixed-capacity frontier buffers.

The paper bounds its input/output lists at 180M states and discards
overflow, marking the run inexact.  A frontier keeps those semantics: a
fixed ``(cap, W)`` buffer of int32 words, the live row count, and a drop
counter (``repro.core.frontier``).  Here it is a plain dataclass of
tensors on one device.

``from_numpy`` / ``to_numpy`` carry frontiers across the two packages as
numpy ``uint32`` words: a JAX frontier snapshot seeds the port's engine,
and the port's frontier comes back in the reference's layout.

A lane-batched frontier (``lane_frontiers``) is the same dataclass with a
leading lane axis on every field: states ``(L, cap, W)``, count and
dropped ``(L,)``.  The multi-lane engine (``core.batch``) carries one.
A sharded frontier (``shard_frontiers``) has the same layout with one
search spread over the shards (``core.shard``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bitset


@dataclasses.dataclass
class Frontier:
    states: torch.Tensor     # ([L,] cap, W) int32 words
    count: torch.Tensor      # ([L],) int32
    dropped: torch.Tensor    # ([L],) int32 — overflow accumulator

    @property
    def cap(self) -> int:
        return self.states.shape[-2]

    @property
    def w(self) -> int:
        return self.states.shape[1]

    def to_numpy(self) -> tuple:
        """(states ([L,] cap, W) uint32, count, dropped) on the host; the
        counts are ints, or (L,) int32 arrays with a lane axis."""
        if self.states.dim() == 3:
            return (bitset.from_words(self.states),
                    self.count.cpu().numpy(), self.dropped.cpu().numpy())
        return (bitset.from_words(self.states), int(self.count),
                int(self.dropped))


def _counts(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.int64),
                           device=device).to(torch.int32)


def empty_frontier(cap: int, w: int, device) -> Frontier:
    """Frontier holding just the empty set (the DP root)."""
    return Frontier(states=torch.zeros((cap, w), dtype=torch.int32,
                                       device=device),
                    count=_counts(1, device), dropped=_counts(0, device))


def lane_frontiers(lanes: int, cap: int, w: int, device) -> Frontier:
    """Batched DP roots: one ``{∅}`` frontier per lane."""
    return Frontier(states=torch.zeros((lanes, cap, w), dtype=torch.int32,
                                       device=device),
                    count=torch.ones((lanes,), dtype=torch.int32,
                                     device=device),
                    dropped=torch.zeros((lanes,), dtype=torch.int32,
                                        device=device))


def shard_frontiers(shards: int, cap: int, w: int, device) -> Frontier:
    """One instance's DP root split across ``shards`` frontier shards
    (``core.shard``): the single ``{∅}`` root lives in shard 0.  States
    ``(S, cap, W)``, count and dropped ``(S,)``."""
    count = torch.zeros((shards,), dtype=torch.int32, device=device)
    count[0] = 1
    return Frontier(states=torch.zeros((shards, cap, w), dtype=torch.int32,
                                       device=device),
                    count=count,
                    dropped=torch.zeros((shards,), dtype=torch.int32,
                                        device=device))


def from_numpy(states_u32: np.ndarray, count, dropped,
               device) -> Frontier:
    """Frontier from a host ``([L,] cap, W)`` uint32 buffer (e.g. a JAX
    frontier snapshot); ``count`` and ``dropped`` are ints, or (L,)
    arrays with a lane axis."""
    return Frontier(states=bitset.to_words(states_u32, device),
                    count=_counts(count, device),
                    dropped=_counts(dropped, device))


def frontier_bytes(cap: int, w: int, lanes: int = 1) -> int:
    """Device bytes of a ``(lanes, cap, W)`` frontier pool of 32-bit words."""
    return 4 * max(1, lanes) * max(1, cap) * max(1, w)


def to_host(f: Frontier) -> np.ndarray:
    """Materialise the live rows as uint32 (for reconstruction)."""
    return bitset.from_words(f.states[:int(f.count)])


def lane_to_host(f: Frontier, lane: int) -> np.ndarray:
    """Materialise one lane's live rows of a lane-batched frontier."""
    return bitset.from_words(f.states[lane, :int(f.count[lane])])
