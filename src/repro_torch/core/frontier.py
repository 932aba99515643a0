"""Fixed-capacity frontier buffers.

The paper bounds its input/output lists at 180M states and discards
overflow, marking the run inexact.  A frontier keeps those semantics: a
fixed ``(cap, W)`` buffer of int32 words, the live row count, and a drop
counter (``repro.core.frontier``).  Here it is a plain dataclass of
tensors on one device.

``from_numpy`` / ``to_numpy`` carry frontiers across the two packages as
numpy ``uint32`` words: a JAX frontier snapshot seeds the port's engine,
and the port's frontier comes back in the reference's layout.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bitset


@dataclasses.dataclass
class Frontier:
    states: torch.Tensor     # (cap, W) int32 words
    count: torch.Tensor      # () int32
    dropped: torch.Tensor    # () int32 — overflow accumulator

    @property
    def cap(self) -> int:
        return self.states.shape[0]

    @property
    def w(self) -> int:
        return self.states.shape[1]

    def to_numpy(self) -> tuple:
        """(states (cap, W) uint32, count, dropped) on the host."""
        return (bitset.from_words(self.states), int(self.count),
                int(self.dropped))


def _scalar(x: int, device) -> torch.Tensor:
    return torch.tensor(int(x), dtype=torch.int32, device=device)


def empty_frontier(cap: int, w: int, device) -> Frontier:
    """Frontier holding just the empty set (the DP root)."""
    return Frontier(states=torch.zeros((cap, w), dtype=torch.int32,
                                       device=device),
                    count=_scalar(1, device), dropped=_scalar(0, device))


def from_numpy(states_u32: np.ndarray, count: int, dropped: int,
               device) -> Frontier:
    """Frontier from a host ``(cap, W)`` uint32 buffer (e.g. a JAX
    frontier snapshot)."""
    return Frontier(states=bitset.to_words(states_u32, device),
                    count=_scalar(count, device),
                    dropped=_scalar(dropped, device))


def frontier_bytes(cap: int, w: int, lanes: int = 1) -> int:
    """Device bytes of a ``(lanes, cap, W)`` frontier pool of 32-bit words."""
    return 4 * max(1, lanes) * max(1, cap) * max(1, w)


def to_host(f: Frontier) -> np.ndarray:
    """Materialise the live rows as uint32 (for reconstruction)."""
    return bitset.from_words(f.states[:int(f.count)])
