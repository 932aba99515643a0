"""The reference's per-architecture train-step smoke
(``tests/test_models_smoke.py::test_train_step_smoke``) on the port, and
one train step of every ``ARCH_IDS`` architecture under ``reduced``
against the reference's from the same state (ROADMAP A14b): the second
half of ``ARCH_IDS`` here, the first in ``test_torch_train_smoke_twin.py``
(the twins take about 90 s together on one core).

Tolerances (``test_torch_train.py`` gives the reasons): the metrics
within 1e-4 of the reference's (``lm_twins`` F32_TOL); the gradients
within GRAD_TOL = 1e-3 of each leaf's range; AdamW's ``m`` within GRAD_TOL
and ``v`` within 2 * GRAD_TOL; the parameters within what each package's
own ``m`` and ``v`` give.

llama4-maverick runs in bfloat16 with routing ties (``test_torch_models``):
the reference's own jitted and op-by-op gradients differ by up to 0.34 of
a leaf's range there (``tests/lm_conditioning.py`` item 7), so no
leaf-wise comparison of its gradients or of the parameters they move can
hold.  Its twin holds the metrics within BF16_TOL = 5e-2, and the port
alone the smoke's properties."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import TrainConfig as RefTrainConfig
from repro.train import step as ref_step
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.models import Model
from repro_torch.models.params import flat_params, state_from_reference, \
    state_to_reference
from repro_torch.train import step as step_lib

from lm_twins import one_torch_thread  # noqa: F401  (autouse)
from lm_twins import (assert_close, front, model_pair,
                      stacked_grads, tol_for, tree_np)
from test_torch_train import GRAD_TOL, _check_adamw

BATCH, SEQ = 2, 32
TCFG = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10)


def _front(cfg, batch):
    dt = getattr(torch, cfg.dtype)
    out = {}
    if cfg.frontend == "audio":
        out["enc_embeds"] = torch.full((batch, cfg.encoder_len, cfg.d_model),
                                       0.01, dtype=dt)
    if cfg.frontend == "vision":
        out["prefix_embeds"] = torch.full(
            (batch, cfg.frontend_len, cfg.d_model), 0.01, dtype=dt)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_smoke(arch):
    cfg = reduced(get_config(arch))
    model = Model(cfg, device="cpu")
    # warmup 0: the lr ramp starts at 0, and a single-step smoke test needs
    # a non-zero update to observe parameter movement
    tcfg = TrainConfig(**TCFG)
    state = step_lib.init_state(model, tcfg)
    before = [p.detach().clone() for p in flat_params(model)]
    step_fn = step_lib.build_train_step(model, tcfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (BATCH, SEQ)).astype(np.int32))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, dims=1),
             "mask": torch.ones((BATCH, SEQ))}
    batch.update(_front(cfg, BATCH))
    new_state, metrics = step_fn(state, batch)
    assert bool(torch.isfinite(metrics["loss"])), arch
    assert bool(torch.isfinite(metrics["grad_norm"])), arch
    assert int(new_state["step"]) == 1
    # params actually changed
    changed = any(not torch.equal(a, b)
                  for a, b in zip(before, flat_params(model)))
    assert changed, arch


@pytest.mark.parametrize("arch", ARCH_IDS[len(ARCH_IDS) // 2:])
def test_train_step_twin(arch):
    train_step_twin(arch)


def train_step_twin(arch):
    """One train step of ``arch`` (reduced) in both packages from the
    reference's initial state, held as the module docstring says."""
    rcfg, rm, rp, cfg, pm = model_pair(arch)
    rt, pt = RefTrainConfig(**TCFG), TrainConfig(**TCFG)
    rs = ref_step.init_state(rm, jax.random.PRNGKey(0), rt)
    ps = state_from_reference(pm, tree_np(rs))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    b = {"tokens": toks, "targets": np.roll(toks, -1, axis=1),
         "mask": np.ones((BATCH, SEQ), np.float32)}
    b.update(front(cfg, BATCH, rng))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    p0 = tree_np(rs["params"])
    bf16 = cfg.dtype == "bfloat16"
    if not bf16:
        rg = jax.jit(jax.grad(
            lambda p: ref_step._loss_fn(rm, rt, p, jb)[0]))(rs["params"])
        g, _ = step_lib.grads_of(pm, pt, tb)
        for a, c in zip(jax.tree.leaves(stacked_grads(pm, g)),
                        jax.tree.leaves(rg)):
            assert_close(a, c, GRAD_TOL, f"{arch} grads")
    rs, rmet = jax.jit(ref_step.build_train_step(rm, rt))(rs, jb)
    ps, pmet = step_lib.build_train_step(pm, pt)(ps, tb)
    assert set(pmet) == set(rmet)
    for k in rmet:
        assert_close(pmet[k], rmet[k], tol_for(cfg.dtype), f"{arch} {k}")
    got = state_to_reference(ps)
    assert int(got["step"]) == 1 and int(got["opt"]["count"]) == 1
    if not bf16:
        _check_adamw(got, tree_np(rs), p0, float(rmet["lr"]), 1)
