"""The sharded train step (``train.step.shard_state`` and the model's
DTensor paths, ROADMAP A14c) on meshes.

  * The five reduced archs of ``tests/test_dryrun_smoke.py``'s
    ``test_reduced_cells_lower_on_4x4_mesh`` run the sharded train step on
    a fake 4x4 mesh (meta tensors, in a subprocess: the fake group is
    process-wide), with FLOPs and collectives recorded.
  * On 4 gloo ranks of the CPU (a 2x2 ``(data, model)`` mesh, the
    reference's parameters carried across), the sharded loss of reduced
    qwen3 and granite-moe equals the unsharded port's and the reference's
    on one device within LOSS_TOL relative, and the gradients are within
    GRAD_TOL of each leaf's max |unsharded| (|reference|).  Sharded sums
    add in another order, and the init's gradients are ill-conditioned
    (``tests/lm_conditioning.py`` item 6; the twins' tolerance).  gloo has
    every collective DTensor issues here; DTensor itself replaces gloo's
    missing all-to-all by an all-gather and a chunk (its warning "CPU
    process group does not support alltoall yet").
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get, reduced as ref_reduced
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.models import Model as RefModel
from repro.train import step as ref_step
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.core import distributed
from repro_torch.models import Model
from repro_torch.train import step as step_lib

import torch_mesh_twins as twins
from lm_twins import one_torch_thread  # noqa: F401  (autouse)
from lm_twins import assert_close, load, stacked_grads, tree_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REDUCE = dict(d_model=64, n_heads=4, n_kv=2, d_ff=128)
FAKE_ARCHS = ["qwen3-0.6b", "granite-moe-1b-a400m", "xlstm-1.3b",
              "hymba-1.5b", "whisper-small"]
GLOO_ARCHS = ["qwen3-0.6b", "granite-moe-1b-a400m"]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-3
BATCH, SEQ = 8, 32

_FAKE = """
import json, torch
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.launch import dryrun as d
from repro_torch.launch import mesh as mesh_lib
torch.set_num_threads(1)
mesh = mesh_lib.make_mesh((4, 4), ("data", "model"), "cpu")
meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
out = {}
for arch in %r:
    cfg = reduced(get_config(arch)).replace(**%r)
    specs = {"tokens": meta((8, 64), torch.int32),
             "targets": meta((8, 64), torch.int32),
             "mask": meta((8, 64), torch.float32)}
    if cfg.frontend == "audio":
        specs["enc_embeds"] = meta((8, cfg.encoder_len, cfg.d_model),
                                   torch.float32)
    if cfg.frontend == "vision":
        specs["prefix_embeds"] = meta((8, cfg.frontend_len, cfg.d_model),
                                      torch.float32)
    rec = d.run_train(cfg, TrainConfig(), specs, mesh, torch.device("cpu"))
    out[arch] = rec
print("RESULT " + json.dumps(out))
""" % (FAKE_ARCHS, REDUCE)


@pytest.fixture(scope="module")
def fake_cells():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(_FAKE)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    line = [ln for ln in run.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("arch", FAKE_ARCHS)
def test_reduced_cells_run_sharded_on_a_fake_4x4_mesh(fake_cells, arch):
    rec = fake_cells[arch]
    assert rec["flops_per_device"] > 0
    assert rec["collectives_scaled"]["total_bytes"] > 0
    assert sum(rec["collective_ops"].values()) > 0
    # the batch and the state are split over 16 ranks: a rank holds less
    # than the whole, and its peak holds at least its arguments
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1].copy(), "targets": toks[:, 1:].copy(),
            "mask": np.ones((BATCH, SEQ), np.float32)}


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_sharded_step_on_gloo_equals_unsharded_and_reference(arch):
    rcfg = ref_reduced(ref_get(arch)).replace(**REDUCE)
    cfg = reduced(get_config(arch)).replace(**REDUCE)
    rm = RefModel(rcfg)
    rp = rm.init(jax.random.PRNGKey(0))
    tree = tree_np(rp)
    b = _batch(cfg)

    ranks = distributed.launch(twins.sharded_grads, int(np.prod(twins.MESH)),
                               arch, REDUCE, tree, b, device="cpu")
    got = ranks[0]
    assert got["sharded"] > 0
    for r in ranks[1:]:
        assert r["metrics"] == got["metrics"]

    pm = load(Model(cfg, device="cpu"), tree)
    g, met = step_lib.grads_of(pm, TrainConfig(),
                               {k: torch.from_numpy(v) for k, v in b.items()})
    rt = RefTrainConfig()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (_, rmet), rg = jax.value_and_grad(
        lambda p: ref_step._loss_fn(rm, rt, p, jb), has_aux=True)(rp)
    for k in ("loss", "nll", "aux"):
        for want in (float(met[k]), float(rmet[k])):
            assert abs(got["metrics"][k] - want) <= LOSS_TOL * abs(want), k
    sharded = jax.tree.leaves(stacked_grads(pm, got["grads"]))
    for want in (jax.tree.leaves(stacked_grads(pm, g)),
                 jax.tree.leaves(rg)):
        for a, c in zip(sharded, want):
            assert_close(a, c, GRAD_TOL, f"{arch} sharded grads")
