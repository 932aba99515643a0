"""The port's train step against the reference's (ROADMAP A14b), and the
reference's training tests on the port (``tests/test_train.py``:
``test_loss_decreases``, ``test_optimizers_learn``,
``test_grad_accumulation_equivalence``), and ``remat``.

Each twin step starts the port from the reference's state before that
step (``params.state_from_reference``), so each of the three steps is
held on its own; the metrics are also held along the port's own three
steps.  Tolerances:

  * metrics (``loss``, ``nll``, ``aux``, ``grad_norm``, ``lr``): max
    |port - ref| <= 1e-4 * max |ref| (``lm_twins`` F32_TOL);
  * gradients: GRAD_TOL = 1e-3 of each leaf's max |ref|.  The reference's
    init (per-layer weights of std 1/sqrt(n_reps)) makes the gradients
    ill-conditioned: moving every weight by a relative 1e-7, about one
    float32 rounding, moves the reference's own gradients by up to 2.2e-4
    of their range after one step (``tests/lm_conditioning.py`` item 6),
    and the port's, which rounds in another order, are within 4.4e-4;
  * AdamW's ``m`` (linear in the clipped gradient) within GRAD_TOL and
    ``v`` (quadratic) within 2 * GRAD_TOL per leaf.  Its update
    m^/(sqrt(v^) + eps) is steep in
    ``v`` and ``m`` where both are near 0 (slope up to 1/eps = 1e8 at the
    first step), so two gradients within 1e-4 of their range can move an
    element by up to about 2 * lr there.  The parameters are therefore held
    to what each package's own ``m`` and ``v`` give: |p_port - p_ref| <=
    lr * |u(port) - u(ref)| + 2e-6 * (|p| + lr * (|u| + 1)), with u the
    update evaluated in float64 from each package's state, the last term
    the float32 rounding of both updates;
  * Adafactor's update is a smooth function of the gradient, normalised
    by its own second moments: parameters within F32_TOL of their leaf's
    range, ``v`` within 2 * GRAD_TOL and ``m`` (bfloat16) within 1e-2 of
    its leaf's range: one bfloat16 step of the leaf's largest element
    (2^-7 of it), where the two float32 momenta round to neighbouring
    bfloat16 values, plus GRAD_TOL.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import ModelConfig as RefModelConfig
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.data.synthetic import SyntheticLM as RefSyntheticLM
from repro.models import Model as RefModel
from repro.train import step as ref_step
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import Model
from repro_torch.models.params import flat_params, state_from_reference, \
    state_to_reference
from repro_torch.train import step as step_lib

from lm_twins import one_torch_thread  # noqa: F401  (autouse)
from lm_twins import F32_TOL, assert_close, stacked_grads, to_np, tree_np

CFG = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv=2, d_ff=128, vocab=256, vocab_pad_multiple=64, attn_chunk=32)
TWIN_LR = 1e-3
GRAD_TOL = 1e-3
# one bfloat16 step of a leaf's largest element (2^-7 of it) + GRAD_TOL
M_BF16_TOL = 1e-2
TWIN_STEPS = 3


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pair(opt, micro, lr=TWIN_LR):
    kw = dict(learning_rate=lr, warmup_steps=0, total_steps=10,
              microbatch=micro, optimizer=opt)
    rm, rt = RefModel(RefModelConfig(**CFG)), RefTrainConfig(**kw)
    pm, pt = Model(ModelConfig(**CFG), device="cpu"), TrainConfig(**kw)
    return rm, rt, pm, pt


def _adamw_u(m, v, count, b1=0.9, b2=0.95, eps=1e-8):
    m, v = np.asarray(m, np.float64), np.asarray(v, np.float64)
    return (m / (1 - b1 ** count)) / (np.sqrt(v / (1 - b2 ** count)) + eps)


def _leaves(tree):
    return [to_np(x) for x in jax.tree.leaves(tree)]


def _check_adamw(got, want, p0, lr, count):
    for name, tol in (("m", GRAD_TOL), ("v", 2 * GRAD_TOL)):
        for a, b in zip(_leaves(got["opt"][name]), _leaves(want["opt"][name])):
            assert_close(a, b, tol, f"adamw {name}")
    for pp, pr, mp, vp, mr, vr, p in zip(
            _leaves(got["params"]), _leaves(want["params"]),
            _leaves(got["opt"]["m"]), _leaves(got["opt"]["v"]),
            _leaves(want["opt"]["m"]), _leaves(want["opt"]["v"]),
            _leaves(p0)):
        up, ur = _adamw_u(mp, vp, count), _adamw_u(mr, vr, count)
        bound = lr * np.abs(up - ur) + 2e-6 * (
            np.abs(p) + lr * (np.abs(ur) + 1))
        assert np.all(np.abs(pp.astype(np.float64) - pr) <= bound)


def _check_adafactor(got, want):
    for a, b in zip(_leaves(got["params"]), _leaves(want["params"])):
        assert_close(a, b, F32_TOL, "adafactor params")
    for a, b in zip(_leaves(got["opt"]["v"]), _leaves(want["opt"]["v"])):
        assert_close(a, b, 2 * GRAD_TOL, "adafactor v")
    for a, b in zip(_leaves(got["opt"]["m"]), _leaves(want["opt"]["m"])):
        assert_close(a, b, M_BF16_TOL, "adafactor m")


@pytest.mark.parametrize("micro", [0, 2, 4])
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_train_step_twin(opt, micro):
    rm, rt, pm, pt = _pair(opt, micro)
    rs = ref_step.init_state(rm, jax.random.PRNGKey(0), rt)
    ref_fn = jax.jit(ref_step.build_train_step(rm, rt))
    ref_grad = jax.jit(jax.grad(
        lambda p, b: ref_step._loss_fn(rm, rt, p, b)[0]))
    port_fn = step_lib.build_train_step(pm, pt)
    data = RefSyntheticLM(vocab=256, seq_len=32, global_batch=8, seed=2)
    own_pm = Model(ModelConfig(**CFG), device="cpu")
    own = state_from_reference(own_pm, tree_np(rs))
    for i in range(TWIN_STEPS):
        b = data.batch_at(i)
        ps = state_from_reference(pm, tree_np(rs))
        g, _ = step_lib.grads_of(pm, pt, _tb(b))
        for a, c in zip(jax.tree.leaves(stacked_grads(pm, g)),
                        jax.tree.leaves(ref_grad(rs["params"], _jb(b)))):
            assert_close(a, c, GRAD_TOL, f"step {i} grads")
        p0 = tree_np(rs["params"])
        rs, rmet = ref_fn(rs, _jb(b))
        ps, pmet = port_fn(ps, _tb(b))
        assert set(pmet) == set(rmet)
        for k in rmet:
            assert_close(pmet[k], rmet[k], F32_TOL, f"step {i} {k}")
        got, want = state_to_reference(ps), tree_np(rs)
        assert int(got["step"]) == int(want["step"]) == i + 1
        assert int(got["opt"]["count"]) == int(want["opt"]["count"])
        if opt == "adamw":
            _check_adamw(got, want, p0, float(rmet["lr"]), i + 1)
        else:
            _check_adafactor(got, want)
        # the port along its own steps: the metrics still hold
        own, omet = port_fn(own, _tb(b))
        for k in ("loss", "nll", "aux", "lr"):
            assert_close(omet[k], rmet[k], F32_TOL, f"own step {i} {k}")


def _batch(data, i):
    return _tb(data.batch_at(i))


def _model(seed=0):
    return Model(ModelConfig(**CFG), device="cpu", seed=seed)


def test_loss_decreases():
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=5, total_steps=60)
    m = _model()
    state = step_lib.init_state(m, tcfg)
    fn = step_lib.build_train_step(m, tcfg)
    data = SyntheticLM(vocab=256, seq_len=64, global_batch=8, seed=1)
    losses = []
    for i in range(30):
        state, metrics = fn(state, _batch(data, i))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.3
    assert losses[-1] < math.log(256)      # beats uniform


def test_grad_accumulation_equivalence():
    data = SyntheticLM(vocab=256, seq_len=32, global_batch=8, seed=2)
    b = _batch(data, 0)
    outs = []
    for micro in (0, 2, 4):
        tcfg = TrainConfig(learning_rate=1e-2, microbatch=micro)
        m = _model()
        st = step_lib.init_state(m, tcfg)
        st, _ = step_lib.build_train_step(m, tcfg)(st, b)
        outs.append([p.detach().clone() for p in flat_params(m)])
    for leaves in outs[1:]:
        for a, c in zip(outs[0], leaves):
            assert float(torch.max(torch.abs(a - c))) < 1e-4


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizers_learn(opt):
    tcfg = TrainConfig(learning_rate=5e-3, warmup_steps=2, total_steps=40,
                       optimizer=opt)
    m = _model()
    state = step_lib.init_state(m, tcfg)
    fn = step_lib.build_train_step(m, tcfg)
    data = SyntheticLM(vocab=256, seq_len=32, global_batch=8, seed=3)
    first = last = None
    for i in range(25):
        state, metrics = fn(state, _batch(data, i))
        first = first if first is not None else float(metrics["loss"])
        last = float(metrics["loss"])
    assert last < first - 0.2, (opt, first, last)


class _BackwardOps(TorchDispatchMode):
    """Counts the aten ops run inside it: products, and the rest."""

    def __init__(self):
        super().__init__()
        self.dots = self.other = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                    torch.ops.aten.addmm.default):
            self.dots += 1
        else:
            self.other += 1
        return func(*args, **(kwargs or {}))


def _remat_run(remat, batch):
    """Gradients and metrics under ``remat``, and the ops the backward
    pass ran."""
    m = Model(ModelConfig(**CFG, remat=remat), device="cpu")
    total, metrics = step_lib._loss_fn(m, TrainConfig(), batch)
    params = flat_params(m)
    with _BackwardOps() as ops:
        g = torch.autograd.grad(total, params)
    return g, metrics, ops


def test_remat_gives_the_same_gradients_and_recomputes():
    """``remat`` "full" and "dots" against "none": the same gradients
    (within 1e-6 of each leaf's range: the recomputation repeats the same
    float32 ops on the same inputs); the backward pass recomputes the
    unit's ops, and under "dots" not its products, which it kept."""
    b = _batch(SyntheticLM(vocab=256, seq_len=32, global_batch=4, seed=4), 0)
    g0, m0, ops0 = _remat_run("none", b)
    ops = {}
    for remat in ("full", "dots"):
        g, m, ops[remat] = _remat_run(remat, b)
        for k in m0:
            assert_close(m[k], m0[k], 1e-6, f"{remat} {k}")
        for a, c in zip(g, g0):
            assert_close(a, c, 1e-6, f"{remat} grads")
    assert ops["full"].dots > ops["dots"].dots == ops0.dots
    assert ops["full"].other > ops0.other and ops["dots"].other > ops0.other


def test_remat_argument_overrides_the_config():
    b = _batch(SyntheticLM(vocab=256, seq_len=32, global_batch=2, seed=5), 0)
    m = _model()
    want = m(b["tokens"])[0]
    got = m(b["tokens"], remat="full")[0]
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="remat"):
        m(b["tokens"], remat="bogus")


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_twin(remat):
    """The reference's gradients under ``cfg.remat`` against the port's,
    within GRAD_TOL of each leaf's range."""
    rcfg = RefModelConfig(**CFG, remat=remat)
    rm = RefModel(rcfg)
    rp = rm.init(jax.random.PRNGKey(3))
    pm = Model(ModelConfig(**CFG, remat=remat), device="cpu")
    state_from_reference(pm, {"params": tree_np(rp), "opt": {},
                              "step": np.int32(0)})
    b = RefSyntheticLM(vocab=256, seq_len=32, global_batch=4,
                       seed=6).batch_at(0)
    rt = RefTrainConfig()
    rg = jax.jit(jax.grad(
        lambda p: ref_step._loss_fn(rm, rt, p, _jb(b))[0]))(rp)
    g, _ = step_lib.grads_of(pm, TrainConfig(), _tb(b))
    for a, c in zip(jax.tree.leaves(stacked_grads(pm, g)),
                    jax.tree.leaves(rg)):
        assert_close(a, c, GRAD_TOL, f"{remat} grads")
