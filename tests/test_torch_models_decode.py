"""Prefill and decode of the port against the reference's (ROADMAP A14a)
for the five architectures of ``test_models_smoke.py::test_decode_smoke``,
one per cache kind (KV / window + SSM / pure state / cross / MoE): logits
of the prefill and of 4 decode steps, and the caches after the prefill;
a decode past the end of a small cache (the write clamps to the last
slot); the VLM's first decode position; and the reference's decode smoke
on the port alone.

The reference runs jitted, the port on the CPU with the reference's
parameters carried across.  Both decode the reference's greedy tokens,
and the port's argmax must equal them wherever the reference's top-two
margin exceeds the tolerance.  Tolerance (``lm_twins``): float32 max
|port - ref| <= 1e-4 * max |ref|.  The sLSTM state of xlstm-1.3b's last
layer is held to 1e-3 of its range: with n_reps = 1 the init rule gives
its input
weights std 1, its gate pre-activations reach |g| = 33 on unit-rms
inputs, and exp(g) turns the float32 rounding of the seven mLSTM layers
before it (their states within 6.6e-6 of the reference's) into 1.4e-4 of
the sLSTM state (``tests/lm_conditioning.py``); the logits hold at 1e-4,
and ``test_torch_ssm.py`` holds the sLSTM block itself at 1e-4 on the
same inputs in both packages."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.engine import Engine as RefEngine
from repro_torch.configs import get_config, reduced
from repro_torch.models import Model
from repro_torch.serve.engine import Engine

from lm_twins import one_torch_thread  # noqa: F401  (autouse)
from lm_twins import (F32_TOL, assert_close, assert_tree_close, front, j,
                      model_pair, stack_cache, t, to_np, top2_margin)

BATCH, SEQ = 2, 32
DECODE_ARCHS = ["qwen3-0.6b", "hymba-1.5b", "xlstm-1.3b", "whisper-small",
                "granite-moe-1b-a400m"]
SLSTM_STATE_TOL = 1e-3


def _assert_caches(pc, rc, tol, what):
    rc = jax.tree.map(np.asarray, rc)
    for lname, group in rc.items():
        for kind, entry in group.items():
            leaf_tol = max(tol, SLSTM_STATE_TOL) if kind == "slstm" else tol
            assert_tree_close(pc[lname][kind], entry, leaf_tol,
                              what=f"{what}/{lname}/{kind}")


def _ref_steps(rm):
    prefill = jax.jit(functools.partial(rm.apply, mode="prefill"))
    decode = jax.jit(functools.partial(rm.apply, mode="decode"))
    return prefill, decode


def _twin_decode(arch, cache_len, steps=4, seed=0):
    rcfg, rm, rp, cfg, pm = model_pair(arch)
    tol = F32_TOL
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    kw = front(cfg, BATCH, rng)
    prefill, decode = _ref_steps(rm)
    rcache = rm.init_cache(BATCH, cache_len)
    pcache = pm.init_cache(BATCH, cache_len)
    rl, rcache, _ = prefill(rp, j(toks), cache=rcache,
                            **{k: j(v) for k, v in kw.items()})
    with torch.no_grad():
        pl, pcache, _ = pm(t(toks), mode="prefill", cache=pcache,
                           **{k: t(v) for k, v in kw.items()})
    assert_close(pl, rl, tol, what="prefill logits")
    prefill_caches = (stack_cache(pcache), rcache)
    pos = np.full((BATCH,), SEQ, np.int32)
    tok = np.asarray(jnp.argmax(rl[:, -1:], axis=-1)).astype(np.int32)
    for step in range(steps):
        rl, rcache, _ = decode(rp, j(tok), cache=rcache, pos=j(pos))
        with torch.no_grad():
            pl, pcache, _ = pm(t(tok), mode="decode", cache=pcache,
                               pos=t(pos))
        assert_close(pl, rl, tol, what=f"decode {step}")
        rtok = np.asarray(jnp.argmax(rl[:, 0], axis=-1)).astype(np.int32)
        ptok = to_np(torch.argmax(pl[:, 0], dim=-1))
        clear = top2_margin(rl[:, 0]) > tol * float(jnp.max(jnp.abs(rl)))
        assert np.array_equal(ptok[clear], rtok[clear]), step
        tok = rtok[:, None]
        pos = pos + 1
    return prefill_caches, (stack_cache(pcache), rcache), tol


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_decode_twin(arch):
    (pc, rc), _, tol = _twin_decode(arch, SEQ + 8)
    _assert_caches(pc, rc, tol, f"{arch} cache")


def test_decode_past_the_cache_end_twin():
    """A cache of SEQ + 2 slots and 4 decode steps: the last two writes
    clamp to the last slot in both packages."""
    _, (pc, rc), tol = _twin_decode("qwen3-0.6b", SEQ + 2)
    _assert_caches(pc, rc, tol, "cache")


def test_vlm_first_decode_position_twin():
    """phi-3-vision: ``generate_greedy`` starts decode at pos = S (the text
    length), so with P prefix positions its first decode writes over cache
    slot S, which the prefix filled.  The port mirrors the reference; no
    decode = forward property is asserted here."""
    rcfg, rm, rp, cfg, pm = model_pair("phi-3-vision-4.2b")
    s, new = 4, 4
    cache_len = cfg.frontend_len + s + new
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab, (BATCH, s)).astype(np.int32)
    pe = front(cfg, BATCH, rng)["prefix_embeds"]
    rgen = np.asarray(RefEngine(rm, BATCH, cache_len).generate_greedy(
        rp, j(prompts), new, prefix_embeds=j(pe)))
    eng = Engine(pm, BATCH, cache_len)
    pgen = eng.generate_greedy(t(prompts), new, prefix_embeds=t(pe))
    assert np.array_equal(to_np(pgen), rgen)
    # the first decode's write lands on slot s, inside the prefix
    cache = eng.new_cache()
    last, cache = eng.prefill(t(prompts), cache, prefix_embeds=t(pe))
    before = cache[0]["layer0"]["attn"]["k"].clone()
    tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    _, cache = eng.decode(tok, cache, torch.full((BATCH,), s))
    after = cache[0]["layer0"]["attn"]["k"]
    changed = torch.nonzero(torch.any(after != before, dim=(0, 2, 3)))
    assert changed.flatten().tolist() == [s] and s < cfg.frontend_len


# ---------------------------------- the reference's decode smoke, on the port

@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_smoke(arch):
    cfg = reduced(get_config(arch))
    model = Model(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    toks = t(rng.integers(0, cfg.vocab, (BATCH, SEQ)))
    cache = model.init_cache(BATCH, SEQ + 8)
    kw = {}
    if cfg.frontend == "audio":
        kw["enc_embeds"] = torch.ones(BATCH, cfg.encoder_len,
                                      cfg.d_model) * 0.01
    with torch.no_grad():
        logits, cache, _ = model(toks, mode="prefill", cache=cache, **kw)
        pos = torch.full((BATCH,), SEQ, dtype=torch.int32)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        for _ in range(4):
            step_logits, cache, _ = model(tok, mode="decode", cache=cache,
                                          pos=pos)
            assert bool(torch.all(torch.isfinite(step_logits))), arch
            tok = torch.argmax(step_logits, dim=-1).to(torch.int32)
            tok = tok.reshape(BATCH, 1)
            pos = pos + 1
