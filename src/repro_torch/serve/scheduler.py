"""Slot-based continuous batching scheduler (LM decode; the port of
``repro.serve.scheduler``).

A fixed pool of B decode slots (``repro_torch.serve.slots.SlotPool`` — the
admission core shared with the treewidth solve scheduler).  Admission is
**token-at-a-time**: a newly admitted request streams its prompt through
the shared batched decode step (one token per tick) until the prompt is
exhausted, then flips to generation.  Finished sequences release their
slot immediately.

Token-at-a-time admission is exact for every architecture — KV caches,
sliding-window ring buffers and recurrent SSM states all advance per
token with per-slot positions, so no padding or masking corrections are
needed — and one decode step serves the whole loop.  Aligned batches can
use ``Engine.prefill`` directly.  A slot's cache is not cleared when a new
request takes it: positions restart at 0 and overwrite it, as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .slots import SlotPool


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_tokens: int
    eos_id: Optional[int] = None
    output: Optional[list] = None


@dataclasses.dataclass
class _Slot:
    request: Request
    pos: int = 0                 # next cache position to write
    fed: int = 0                 # prompt tokens already fed
    generated: int = 0


class Scheduler:
    def __init__(self, engine):
        self.engine = engine
        self.pool = SlotPool(engine.batch)
        self.cache = engine.new_cache()
        self.done: dict = {}
        self.ticks = 0
        self._feed = np.zeros((engine.batch, 1), np.int32)

    def submit(self, req: Request):
        req.output = []
        self.pool.submit(req)

    def _admit(self):
        for i, s in self.pool.admit(lambda req: _Slot(request=req)):
            self._feed[i, 0] = s.request.prompt[0]

    def step(self) -> bool:
        """One engine tick: batched decode over all slots."""
        self._admit()
        active = self.pool.active()
        if not active:
            return False
        pos = np.zeros(len(self.pool), np.int32)
        for i, s in active:
            pos[i] = s.pos
        dev = self.engine.device
        logits, self.cache = self.engine.decode(
            torch.from_numpy(self._feed.copy()).to(dev), self.cache,
            torch.from_numpy(pos).to(dev))
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        self.ticks += 1
        for i, s in active:
            s.pos += 1
            if s.fed < len(s.request.prompt) - 1:
                # still streaming the prompt
                s.fed += 1
                self._feed[i, 0] = s.request.prompt[s.fed]
                continue
            # prompt done: nxt[i] is a generated token
            tok = int(nxt[i])
            s.request.output.append(tok)
            s.generated += 1
            finished = (s.generated >= s.request.max_tokens or
                        (s.request.eos_id is not None
                         and tok == s.request.eos_id))
            if finished:
                self.done[s.request.rid] = s.request
                self.pool.release(i)
            else:
                self._feed[i, 0] = tok
        return True

    def run(self, max_ticks: int = 100_000):
        ticks = 0
        while self.pool.busy and ticks < max_ticks:
            if not self.step():
                break
            ticks += 1
        return self.done
