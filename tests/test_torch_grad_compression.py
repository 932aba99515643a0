"""The port's int8 gradient compression against the reference's (ROADMAP
A14b; ``tests/test_grad_compression.py``): ``quantize_int8`` in one
process, ``compressed_psum`` and the compressed gradients on 8 ``gloo``
ranks on the CPU against the reference's 8 forced host devices, and the
reference's property that compressed training still learns, on the port.

Tolerances.  Quantisation rounds g / scale to the nearest integer, so an
element whose g / scale lies at a half-integer can round either way in
the two packages (XLA may divide by the scale as a product with its
reciprocal): on identical inputs every code is equal except where
g / scale lies within 1e-5 of a half-integer, and the mean then differs
by one quantisation step (scale / ranks) per such code.  The compressed
gradients of a training step come from local gradients that agree to
GRAD_TOL = 1e-3 of their range (``test_torch_train.py``), so each rank's
code may differ by one: the mean within one step of the shared scale
(ranks x scale / ranks) plus GRAD_TOL of the leaf's range."""
import pickle
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import Model as RefModel
from repro.configs.base import ModelConfig as RefModelConfig
from repro.train.step import quantize_int8 as ref_quantize
from repro_torch.train.step import quantize_int8

import torch_dist_twins as twins
from lm_twins import one_torch_thread  # noqa: F401  (autouse)
from lm_twins import t, tree_np

RANKS = 8
STEPS = 30
GRAD_TOL = 1e-3
CFG = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
           n_kv=2, d_ff=64, vocab=128, vocab_pad_multiple=64)


def _at_half(x, scale):
    """Where |x / scale| lies within 1e-5 of a half-integer."""
    f = np.abs(x.astype(np.float64) / scale) % 1.0
    return np.abs(f - 0.5) < 1e-5


def test_quantize_int8_twin():
    g = (np.random.default_rng(0).standard_normal(1000) * 0.01).astype(
        np.float32)
    q, scale = quantize_int8(t(g))
    rq, rscale = ref_quantize(jnp.asarray(g))
    assert q.dtype == torch.int8 and float(scale) == float(rscale)
    differ = q.numpy() != np.asarray(rq)
    assert not np.any(differ & ~_at_half(g, float(scale)))
    assert np.all(np.abs(q.numpy().astype(int) - np.asarray(rq)) <= 1)
    rec = q.float() * scale
    rel = float(np.linalg.norm(rec.numpy() - g) / np.linalg.norm(g))
    assert rel < 0.01                      # <1% relative error per tensor


def _reference(x, params):
    """The reference on RANKS forced host devices: ``compressed_psum`` of
    x's rows and the compressed gradients of the first training step."""
    with tempfile.TemporaryDirectory() as tmp:
        inp, out = f"{tmp}/in.pkl", f"{tmp}/out.pkl"
        with open(inp, "wb") as f:
            pickle.dump((x, params, CFG), f)
        twins.run_child(textwrap.dedent(f"""
            import pickle
            import numpy as np
            import jax, jax.numpy as jnp
            from jax.sharding import Mesh, PartitionSpec as P
            from repro.configs.base import ModelConfig, TrainConfig
            from repro.data.synthetic import SyntheticLM
            from repro.models import Model
            from repro.train import step as step_lib
            from repro.utils import compat

            x, params, cfg = pickle.load(open({inp!r}, "rb"))
            mesh = Mesh(np.asarray(jax.devices()), ("data",))
            f = jax.jit(compat.shard_map(
                lambda xs: step_lib.compressed_psum(xs, ("data",)),
                mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                axis_names={{"data"}}))
            mean = np.asarray(f(jnp.asarray(x)))
            model = Model(ModelConfig(**cfg))
            tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=0,
                               total_steps=40)
            grads_fn = jax.jit(step_lib.build_compressed_grads(model, tcfg,
                                                               mesh))
            data = SyntheticLM(vocab=cfg["vocab"], seq_len=32,
                               global_batch=8, seed=4)
            b = {{k: jnp.asarray(v) for k, v in data.batch_at(0).items()}}
            p = jax.tree.map(jnp.asarray, params)
            g, _ = grads_fn(p, b)
            pickle.dump((mean, jax.tree.map(np.asarray, g)),
                        open({out!r}, "wb"))
        """), RANKS)
        with open(out, "rb") as f:
            return pickle.load(f)


def test_compressed_psum_and_grads_twin():
    x = (np.random.default_rng(0).standard_normal((RANKS, 256)) * 0.02
         ).astype(np.float32)
    params = tree_np(RefModel(RefModelConfig(**CFG)).init(
        jax.random.PRNGKey(0)))
    ref_mean, ref_grads = _reference(x, params)

    # compressed_psum on identical rows
    got = twins.port(twins.compressed_psum_rows, RANKS, x)
    assert all(np.array_equal(g, got[0]) for g in got)
    scale = float(np.max(np.abs(x))) / 127.0
    for r in range(RANKS):
        np.testing.assert_array_equal(ref_mean[r], ref_mean[0])
    steps = (got[0].astype(np.float64) - ref_mean[0]) / (scale / RANKS)
    assert np.allclose(steps, np.round(steps), atol=1e-3)
    assert np.all(np.abs(np.round(steps)) <=
                  _at_half(x, scale).sum(axis=0))
    want = x.mean(axis=0)
    rel = np.linalg.norm(got[0] - want) / np.linalg.norm(want)
    assert rel < 0.05, rel

    # the compressed gradients of a step, and compressed training learns
    runs = twins.port(twins.compressed_training, RANKS, CFG, params, STEPS)
    first, losses = runs[0]
    assert all(r[1] == losses for r in runs)
    flat = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    assert len(flat) == len(first)
    for path, g_ref in flat:
        key = "/".join(str(k.key) for k in path)
        g_ref = np.asarray(g_ref)
        g, step = first[key]
        err = np.abs(g.astype(np.float64) - g_ref)
        assert np.all(err <= step + GRAD_TOL * np.max(np.abs(g_ref))), (
            key, float(err.max()), np.unravel_index(err.argmax(), err.shape),
            step)
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])
