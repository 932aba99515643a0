"""The port's optimizers against the reference's (ROADMAP A14b):
``global_norm``, ``clip_by_global_norm``, ``warmup_cosine``, AdamW and
Adafactor on identical numpy gradients, parameters and state, and
``opt_state_bytes``; and the reference's own optimizer tests on the port
(``tests/test_train.py``: ``test_adafactor_state_is_factored``,
``test_clip_by_global_norm``, ``test_warmup_cosine_schedule``).

The reference updates its stacked tree, the port its unstacked modules
(one entry per repetition) with the state in the reference's stacked
layout; the reduced qwen3-0.6b holds stacked ``(reps, d)`` leaves (the
norm scales, ``q_norm``/``k_norm``), which Adafactor factors across the
repetitions, and rank-4 attention leaves.

Tolerances.  The updates are the same float32 arithmetic on the same
inputs, which XLA and PyTorch round in another order (XLA's ``rsqrt`` and
reductions): every float32 leaf within 1e-6 of its max |ref|.  Adafactor
rounds its momentum to bfloat16; an element whose float32 value lies
within those roundings of a bfloat16 rounding boundary rounds the other
way, so ``m`` is held to one bfloat16 step (at most 2^-7 of the element's
magnitude) plus the float32 tolerance of its leaf (``m`` can be the
small difference of two larger float32 terms).  Each Adafactor step starts from the reference's state of the
step before, so such a step does not carry into the next; AdamW runs its
steps on its own state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import Model as RefModel
from repro.optim import optimizers as ref_opt
from repro_torch.configs import get_config, reduced
from repro_torch.models import transformer
from repro_torch.models.params import state_from_reference, \
    state_to_reference
from repro_torch.optim import optimizers as opt_lib

from lm_twins import one_torch_thread  # noqa: F401  (autouse)
from lm_twins import flat_grads, model_pair, t, to_np, tree_np

OPT_TOL = 1e-6
STEPS = 3
LR = 1e-2


def _grads(tree, rng, scale=0.01):
    return jax.tree.map(lambda x: (rng.standard_normal(x.shape) * scale)
                        .astype(np.float32), tree)


def _close(port, ref, tol, what):
    p, r = to_np(port), to_np(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    scale = float(np.max(np.abs(r))) if r.size else 0.0
    err = float(np.max(np.abs(p.astype(np.float64) - r))) if r.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} * {scale:.3e}"


def _one_bf16_step(port, ref, what):
    p, r = to_np(port).astype(np.float64), to_np(ref).astype(np.float64)
    assert p.shape == r.shape, what
    bound = 2.0 ** -7 * np.abs(r) + OPT_TOL * np.max(np.abs(r))
    assert np.all(np.abs(p - r) <= bound), what


def _compare_state(port_state, ref_params, ref_opt_state, name):
    got = state_to_reference(port_state)
    want = {"params": tree_np(ref_params), "opt": tree_np(ref_opt_state)}
    flat_got = jax.tree_util.tree_flatten_with_path(
        {"params": got["params"], "opt": got["opt"]})[0]
    flat_want = jax.tree.leaves(want)
    assert len(flat_got) == len(flat_want)
    for (path, a), b in zip(flat_got, flat_want):
        what = f"{name} {jax.tree_util.keystr(path)}"
        assert tuple(a.shape) == b.shape, what
        assert str(a.dtype).replace("torch.", "") == str(b.dtype), what
        if name == "adafactor" and what.split("'")[1:4:2] == ["opt", "m"]:
            _one_bf16_step(a, b, what)
        else:
            _close(a, b, OPT_TOL, what)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_twin(name):
    rcfg, rm, rp, cfg, pm = model_pair("qwen3-0.6b")
    assert rp["layers"]["layer0"]["attn"]["attn"]["k_norm"]["scale"].ndim \
        == 2
    assert rp["layers"]["layer0"]["attn"]["attn"]["wq"].ndim == 4
    ropt = ref_opt.opt_init(name)(rp)
    state = state_from_reference(pm, {"params": tree_np(rp), "opt": ropt,
                                      "step": np.int32(0)})
    update = jax.jit(lambda g, s, p: ref_opt.opt_update(name)(g, s, p,
                                                              lr=LR))
    rng = np.random.default_rng(0)
    for _ in range(STEPS):
        g = _grads(tree_np(rp), rng)
        rp, ropt_new = update(g, ropt, rp)
        opt_lib.opt_update(name)(flat_grads(pm, g), state["opt"], pm, lr=LR)
        _compare_state(state, rp, ropt_new, name)
        assert int(state["opt"]["count"]) == int(ropt_new["count"])
        ropt = ropt_new
        if name == "adafactor":
            # the next step from the reference's state (module docstring)
            state = state_from_reference(pm, {"params": tree_np(rp),
                                              "opt": ropt,
                                              "step": np.int32(0)})


def test_adafactor_factors_stacked_leaves_across_repetitions():
    rcfg, rm, rp, cfg, pm = model_pair("qwen3-0.6b")
    st = opt_lib.adafactor_init(pm)
    vr, vc = st["v"]["layers"]["layer0"]["attn"]["attn"]["k_norm"]["scale"]
    reps, d = rp["layers"]["layer0"]["attn"]["attn"]["k_norm"]["scale"].shape
    assert tuple(vr.shape) == (reps,) and tuple(vc.shape) == (d,)
    want = jax.tree.map(lambda x: x.shape, ref_opt.adafactor_init(rp))
    got = jax.tree.map(lambda x: tuple(x.shape), st)
    assert got == want


def test_global_norm_and_clip_twin():
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal(s).astype(np.float32) * 3
          for s in ((4,), (3, 5), (2, 3, 4))]
    want = ref_opt.global_norm([jnp.asarray(x) for x in xs])
    got = opt_lib.global_norm([t(x) for x in xs])
    _close(got, want, OPT_TOL, "global_norm")
    for max_norm in (1.0, 1e3):
        rc, rn = ref_opt.clip_by_global_norm([jnp.asarray(x) for x in xs],
                                             max_norm)
        pc, pn = opt_lib.clip_by_global_norm([t(x) for x in xs], max_norm)
        _close(pn, rn, OPT_TOL, "norm")
        for a, b in zip(pc, rc):
            assert a.dtype == torch.float32
            _close(a, b, OPT_TOL, f"clipped at {max_norm}")


def test_clip_by_global_norm():
    g = [torch.ones(4) * 10.0, torch.ones(2, 2) * 10.0]
    clipped, norm = opt_lib.clip_by_global_norm(g, 1.0)
    assert abs(float(opt_lib.global_norm(clipped)) - 1.0) < 1e-5
    assert float(norm) > 1.0


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 55, 99, 100, 150])
def test_warmup_cosine_twin(step):
    kw = dict(peak=3e-3, warmup=10, total=100)
    want = ref_opt.warmup_cosine(jnp.asarray(step, jnp.int32), **kw)
    got = opt_lib.warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32
    _close(got, want, OPT_TOL, f"lr at {step}")


def test_warmup_cosine_schedule():
    lr = opt_lib.warmup_cosine(torch.tensor(0), peak=1.0, warmup=10,
                               total=100)
    assert float(lr) == 0.0
    lr = opt_lib.warmup_cosine(torch.tensor(10), peak=1.0, warmup=10,
                               total=100)
    assert abs(float(lr) - 1.0) < 1e-6
    lr_end = opt_lib.warmup_cosine(torch.tensor(100), peak=1.0, warmup=10,
                                   total=100)
    assert float(lr_end) < 0.11


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_opt_state_bytes_equal(arch, name):
    for rcfg, cfg in ((ref_get_config(arch), get_config(arch)),
                      (ref_reduced(ref_get_config(arch)),
                       reduced(get_config(arch)))):
        want = ref_opt.opt_state_bytes(name, RefModel(rcfg).abstract())
        assert opt_lib.opt_state_bytes(name, transformer.lm_spec(cfg)) \
            == want, (arch, name, rcfg.n_layers)


def test_adafactor_state_is_factored():
    _, _, _, _, pm = model_pair("qwen3-0.6b")
    st = opt_lib.adafactor_init(pm)
    pbytes = sum(x.numel() * 4 for x in pm.parameters())
    vbytes = sum(x.numel() * x.element_size()
                 for x in jax.tree.leaves(st["v"]))
    assert vbytes < 0.25 * pbytes          # factored stats are tiny
