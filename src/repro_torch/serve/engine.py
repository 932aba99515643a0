"""Serving engine: prefill / decode steps over a slot-based cache (the port
of ``repro.serve.engine``).

The cache is a fixed pool of B slots (one per concurrent sequence), each
with its own position counter — single-token decode steps run for all slots
at once (continuous batching; the scheduler in scheduler.py fills and
recycles slots).  For SSM/hybrid architectures the per-slot "cache" is the
O(1) recurrent state.

The steps run eagerly under ``torch.inference_mode``.  The model holds its
parameters, so no step takes a parameter tree as the reference's do.
"""
from __future__ import annotations

import torch


class Engine:
    def __init__(self, model, batch: int, cache_len: int):
        self.model = model
        self.cfg = model.cfg
        self.batch = batch
        self.cache_len = cache_len

    @property
    def device(self) -> torch.device:
        return self.model.device

    # --------------------------------------------------------------- api

    def new_cache(self):
        return self.model.init_cache(self.batch, self.cache_len)

    @torch.inference_mode()
    def prefill(self, tokens, cache, **kw):
        """tokens (B, S) for all slots (left-padded prompts share S).
        Returns (last-position logits (B, V), cache)."""
        logits, cache, _ = self.model(tokens, mode="prefill", cache=cache,
                                      **kw)
        return logits[:, -1], cache

    @torch.inference_mode()
    def decode(self, tokens, cache, pos):
        """tokens (B, 1); pos (B,) per-slot positions."""
        logits, cache, _ = self.model(tokens, mode="decode", cache=cache,
                                      pos=pos)
        return logits[:, 0], cache

    @torch.inference_mode()
    def generate_greedy(self, prompts, max_new: int, **kw):
        """Batched greedy decode of prompts (B, S) -> tokens (B, max_new).

        Decode starts at ``pos = S``, the text length, also when
        ``prefix_embeds`` put P positions in front of the text: the first
        decode then writes over cache slot S, as the reference's does."""
        b, s = prompts.shape
        assert b == self.batch
        cache = self.new_cache()
        last, cache = self.prefill(prompts, cache, **kw)
        out = []
        pos = torch.full((b,), s, dtype=torch.int32, device=prompts.device)
        tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
        for _ in range(max_new):
            out.append(tok)
            logits, cache = self.decode(tok, cache, pos)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            pos = pos + 1
        return torch.cat(out, dim=1)
