"""How far float32 can hold the LM twins and phase 11's checks: the
numbers behind the tolerances that ``test_torch_models*.py`` and
``chip_smoke.py`` phase 11 state beyond 1e-4 / 1e-3.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/lm_conditioning.py

On the CPU, both packages (a few minutes; the deepest case holds 24
full-width xlstm layers, about 2.8 GB):

  1. xlstm-1.3b under ``reduced`` (the decode twin's inputs): after the
     prefill, the port's caches against the reference's, the last mLSTM
     layer's and the sLSTM layer's, and the sLSTM's largest gate
     pre-activation;
  2. llama4-maverick under ``reduced`` (bfloat16): the reference's
     jitted forward against its op-by-op forward, three token draws;
  3. xlstm-1.3b at full width cut to one pattern period (8 layers): the
     reference's own cache path (``Engine.prefill`` / ``decode``) against
     its full forward at each greedy step, and the port's beside it;
     then the port alone from its own seeded init (seeds 0-3) at phase
     11's shapes (4 x 32-token prompts, 8 new tokens), the largest
     departure over the steps per seed: ``chip_smoke.py``'s
     LM_PERIOD_TOL for xlstm-1.3b is 4 x the largest of these;
  4. xlstm-1.3b at full width, 8, 16 and 24 layers, and whisper-small at
     full width, 1 and 2 layers: how far the reference's logits move when
     every weight moves by a relative 1e-7;
  5. whisper-small: ``sinusoidal_positions(1500, 768)`` of the two
     packages, and the port against the reference at full width, 1 and 2
     layers;
  6. the train twins' tiny config (``tests/test_torch_train.py``), at the
     reference's state after one AdamW step: how far the reference's
     gradients move when every weight moves by a relative 1e-7 and 3e-7,
     and the port's gradients against the reference's there;
  7. llama4-maverick under ``reduced`` (bfloat16): the reference's jitted
     gradients against its op-by-op gradients.

Every figure is max |a - b| / max |b| over the logits compared, or over
a gradient leaf (the largest over the leaves).
"""
import functools
import sys

import jax
import numpy as np
import torch

from repro.configs import get_config as ref_get
from repro.configs import reduced as ref_reduced
from repro.models import Model as RefModel
from repro.models import layers as ref_layers
from repro.serve.engine import Engine as RefEngine
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import layers as port_layers
from repro_torch.models import ssm as port_ssm
from repro_torch.serve.engine import Engine

from lm_twins import (front, j, load, model_pair, stack_cache, t, to_np,
                      tree_np)


def rel(a, b):
    a, b = to_np(a), to_np(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def xlstm_reduced_states():
    _, rm, rp, cfg, pm = model_pair("xlstm-1.3b")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32)).astype(
        np.int32)
    _, rc, _ = jax.jit(functools.partial(rm.apply, mode="prefill"))(
        rp, j(toks), cache=rm.init_cache(2, 40))
    seen = {}
    block = port_ssm.slstm_block

    def record(p, x, cfg, **kw):
        seen["gates"] = torch.einsum("bsd,dhgy->bshgy", x, p["wx"])
        return block(p, x, cfg, **kw)
    port_ssm.slstm_block = record
    try:
        with torch.no_grad():
            _, pc, _ = pm(t(toks), mode="prefill", cache=pm.init_cache(2, 40))
    finally:
        port_ssm.slstm_block = block
    pc = stack_cache(pc)
    for lname, kind in (("layer6", "mlstm"), ("layer7", "slstm")):
        for leaf, ref in rc[lname][kind].items():
            print(f"xlstm-1.3b reduced prefill cache {lname}/{kind}/{leaf}:"
                  f" port vs reference {rel(pc[lname][kind][leaf], ref):.3e}")
    print(f"xlstm-1.3b reduced: largest sLSTM gate pre-activation "
          f"{float(seen['gates'].abs().max()):.1f}")


def llama4_jit_vs_op_by_op():
    rcfg = ref_reduced(ref_get("llama4-maverick-400b-a17b")).replace(
        remat="none")
    rm = RefModel(rcfg)
    rp = rm.init(jax.random.PRNGKey(0))
    for seed in range(3):
        toks = j(np.random.default_rng(seed).integers(
            0, rcfg.vocab, (2, 32)).astype(np.int32))
        jitted = jax.jit(rm.apply)(rp, toks)[0]
        with jax.disable_jit():
            eager = rm.apply(rp, toks)[0]
        print(f"llama4-maverick reduced, tokens {seed}: reference jitted vs "
              f"op by op {rel(eager, jitted):.3e}")


def xlstm_cache_vs_full(layers=8, steps=6):
    rcfg = ref_get("xlstm-1.3b").replace(n_layers=layers)
    cfg = get_config("xlstm-1.3b").replace(n_layers=layers)
    rm = RefModel(rcfg)
    rp = rm.init(jax.random.PRNGKey(0))
    pm = load(Model(cfg, device="cpu"), tree_np(rp))
    b, s = 2, 32
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)
    reng, peng = RefEngine(rm, b, s + steps), Engine(pm, b, s + steps)
    gen = np.asarray(reng.generate_greedy(rp, j(toks), steps))
    rlast, rc = reng.prefill(rp, j(toks), reng.new_cache())
    plast, pc = peng.prefill(t(toks), peng.new_cache())
    fwd = jax.jit(rm.apply)
    pos = np.full((b,), s, np.int32)
    for step in range(steps):
        if step:
            rlast, rc = reng.decode(rp, j(gen[:, step - 1:step]), rc, j(pos))
            plast, pc = peng.decode(t(gen[:, step - 1:step]), pc, t(pos))
            pos = pos + 1
        seq = np.concatenate([toks, gen[:, :step]], axis=1)
        rfull = fwd(rp, j(seq))[0][:, -1]
        with torch.no_grad():
            pfull = pm(t(seq))[0][:, -1]
        print(f"xlstm-1.3b {layers} layers, step {step}: reference cache "
              f"path vs its full forward {rel(rlast, rfull):.3e}; port "
              f"{rel(plast, pfull):.3e}", flush=True)


def xlstm_port_cache_vs_full(layers=8, seeds=range(4), b=4, s=32,
                             steps=8):
    cfg = get_config("xlstm-1.3b").replace(n_layers=layers)
    for seed in seeds:
        pm = Model(cfg, device="cpu", seed=seed)
        peng = Engine(pm, b, s + steps)
        toks = t(np.random.default_rng(seed).integers(
            0, cfg.vocab, (b, s)).astype(np.int32))
        gen = peng.generate_greedy(toks, steps)
        last, cache = peng.prefill(toks, peng.new_cache())
        pos = torch.full((b,), s, dtype=torch.int32)
        worst = 0.0
        for step in range(steps):
            if step:
                last, cache = peng.decode(gen[:, step - 1:step], cache, pos)
                pos = pos + 1
            with torch.no_grad():
                full = pm(torch.cat([toks, gen[:, :step]], dim=1))[0][:, -1]
            worst = max(worst, rel(last, full))
        print(f"xlstm-1.3b {layers} layers, port's own init seed {seed}, "
              f"{b} x {s} + {steps}: cache path vs full forward up to "
              f"{worst:.3e}", flush=True)


def sensitivity(arch, layers):
    rcfg = ref_get(arch).replace(n_layers=layers)
    if rcfg.encoder_layers:
        rcfg = rcfg.replace(encoder_layers=layers)
    rm = RefModel(rcfg)
    rp = rm.init(jax.random.PRNGKey(0))
    leaves, tdef = jax.tree.flatten(rp)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    moved = jax.tree.unflatten(tdef, [
        a * (1 + 1e-7 * jax.random.normal(k, a.shape))
        for a, k in zip(leaves, keys)])
    rng = np.random.default_rng(0)
    toks = j(rng.integers(0, rcfg.vocab, (1, 33)).astype(np.int32))
    kw = {k: j(v) for k, v in front(rcfg, 1, rng).items()}
    fwd = jax.jit(rm.apply)
    a, b = fwd(rp, toks, **kw)[0][:, -1], fwd(moved, toks, **kw)[0][:, -1]
    print(f"{arch} {layers} layers: reference logits move "
          f"{rel(b, a):.3e} for a relative 1e-7 move of every weight",
          flush=True)


def whisper_positions():
    rp = np.asarray(ref_layers.sinusoidal_positions(1500, 768))
    pp = port_layers.sinusoidal_positions(1500, 768)
    print(f"whisper-small: sinusoidal_positions(1500, 768) port vs "
          f"reference, max abs {float(np.max(np.abs(to_np(pp) - rp))):.3e}")
    for layers in (1, 2):
        rcfg = ref_get("whisper-small").replace(n_layers=layers,
                                                 encoder_layers=layers)
        cfg = get_config("whisper-small").replace(n_layers=layers,
                                                  encoder_layers=layers)
        rm = RefModel(rcfg)
        rparams = rm.init(jax.random.PRNGKey(0))
        pm = load(Model(cfg, device="cpu"), tree_np(rparams))
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab, (1, 33)).astype(np.int32)
        enc = front(cfg, 1, rng)["enc_embeds"]
        r = jax.jit(rm.apply)(rparams, j(toks), enc_embeds=j(enc))[0]
        with torch.no_grad():
            p = pm(t(toks), enc_embeds=t(enc))[0]
        print(f"whisper-small {layers} layers: port vs reference "
              f"{rel(p, r):.3e}", flush=True)


def _worst(a, b):
    return max(rel(x, y) for x, y in zip(jax.tree.leaves(a),
                                         jax.tree.leaves(b)))


def train_grad_sensitivity():
    import test_torch_train as tt
    from lm_twins import stacked_grads
    from repro.data.synthetic import SyntheticLM
    from repro.train import step as ref_step
    from repro_torch.models.params import state_from_reference
    from repro_torch.train import step as step_lib

    rm, rt, pm, pt = tt._pair("adamw", 0)
    rs = ref_step.init_state(rm, jax.random.PRNGKey(0), rt)
    data = SyntheticLM(vocab=256, seq_len=32, global_batch=8, seed=2)
    rs, _ = jax.jit(ref_step.build_train_step(rm, rt))(
        rs, {k: j(v) for k, v in data.batch_at(0).items()})
    b = data.batch_at(1)
    grad = jax.jit(jax.grad(
        lambda p: ref_step._loss_fn(rm, rt, p, {k: j(v) for k, v in
                                                b.items()})[0]))
    want = grad(rs["params"])
    rng = np.random.default_rng(0)
    for eps in (1e-7, 3e-7):
        moved = jax.tree.map(lambda x: x * (1 + eps * rng.standard_normal(
            x.shape).astype(np.float32)), rs["params"])
        print(f"train twin config after one step: reference gradients move "
              f"{_worst(grad(moved), want):.3e} for a relative {eps:g} move "
              f"of every weight", flush=True)
    state_from_reference(pm, tree_np(rs))
    g, _ = step_lib.grads_of(pm, pt, {k: t(v) for k, v in b.items()})
    print(f"train twin config after one step: port gradients vs reference "
          f"{_worst(stacked_grads(pm, g), want):.3e}", flush=True)


def llama4_grad_jit_vs_op_by_op():
    from repro.configs import TrainConfig
    from repro.train import step as ref_step
    _, rm, rp, cfg, _ = model_pair("llama4-maverick-400b-a17b")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    b = {"tokens": j(toks), "targets": j(np.roll(toks, -1, axis=1)),
         "mask": j(np.ones((2, 32), np.float32))}
    loss = lambda p: ref_step._loss_fn(rm, TrainConfig(), p, b)[0]
    jitted = jax.jit(jax.grad(loss))(rp)
    with jax.disable_jit():
        eager = jax.grad(loss)(rp)
    print(f"llama4-maverick reduced: reference gradients jitted vs op by "
          f"op {_worst(eager, jitted):.3e}", flush=True)


def main():
    torch.set_num_threads(4)
    xlstm_reduced_states()
    llama4_jit_vs_op_by_op()
    xlstm_cache_vs_full()
    xlstm_port_cache_vs_full()
    for layers in (8, 16, 24):
        sensitivity("xlstm-1.3b", layers)
    for layers in (1, 2):
        sensitivity("whisper-small", layers)
    whisper_positions()
    train_grad_sensitivity()
    llama4_grad_jit_vs_op_by_op()
    return 0


if __name__ == "__main__":
    sys.exit(main())
