"""Deterministic synthetic LM data pipeline (the port's own copy of
``repro.data.synthetic``, which imports nothing of JAX).

Counter-based (stateless) generation: batch ``step`` is a pure function of
(seed, step), so any restart — same or different host/device count — replays
the exact stream (the determinism leg of the fault-tolerance story).  The
batches are numpy arrays, bit for bit the reference's.

The stream is a noisy affine-recurrence language: ``t_{i+1} = (a*t_i + c +
eps) mod V`` with p_noise-random resets, so an LM can push loss well below
log(V) and training curves are meaningful, while generation stays O(1) per
token and vectorised.
"""
from __future__ import annotations

import numpy as np


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, p_noise: float = 0.15):
        self.vocab = vocab
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.p_noise = p_noise
        self.a = 31 % vocab or 1
        self.c = 17 % vocab

    def batch_at(self, step: int, batch: int | None = None,
                 batch_offset: int = 0):
        """Global batch for ``step`` (or a [offset, offset+batch) slice of it
        for per-host sharded loading)."""
        b = batch if batch is not None else self.batch
        rng = np.random.Philox(key=self.seed, counter=[0, 0, 0, step])
        gen = np.random.Generator(rng)
        full = gen.integers(0, self.vocab,
                            size=(self.batch, self.seq + 1), dtype=np.int64)
        noise = gen.random((self.batch, self.seq + 1)) < self.p_noise
        seqs = np.empty((self.batch, self.seq + 1), dtype=np.int64)
        seqs[:, 0] = full[:, 0]
        for i in range(1, self.seq + 1):
            pred = (self.a * seqs[:, i - 1] + self.c) % self.vocab
            seqs[:, i] = np.where(noise[:, i], full[:, i], pred)
        sl = seqs[batch_offset:batch_offset + b]
        return {
            "tokens": sl[:, :-1].astype(np.int32),
            "targets": sl[:, 1:].astype(np.int32),
            "mask": np.ones((b, self.seq), np.float32),
        }
