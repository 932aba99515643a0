"""The port's dry run against the reference's (ROADMAP A14c;
``tests/test_dryrun_smoke.py``, ``repro.launch.dryrun``).

Both packages run in subprocesses: importing ``repro.launch.dryrun`` sets
``XLA_FLAGS`` to 512 forced host devices, which other tests' subprocesses
would inherit, and the port's meshes start a process-wide fake group of
512 ranks (``launch.mesh``).  Held exactly:

  * ``dryrun_config``, ``tcfg_for`` and ``n_params`` for the ten archs,
    and ``applicable``'s status and reason for the 40 cells;
  * ``make_production_mesh``'s shapes and axis names;
  * on a 4x4 mesh, the per-device argument bytes of XLA's
    ``memory_analysis`` for the reduced qwen3 and granite-moe train cells
    (8 x 64 tokens; 104 456 and 215 816 bytes) and a reduced qwen3 decode
    cell: the port sums the shards its rules place;
  * the output bytes: XLA's count the outputs plus one 8-byte pointer per
    output buffer (its output tuple's index table), the port's the
    outputs;
  * the FLOPs of one train step of each reduced arch, as the dry run
    predicts them on meta tensors (a 1x1 mesh), against
    ``FlopCounterMode`` over a real step on the CPU.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300

# the reduced cells of tests/test_dryrun_smoke.py
REDUCE = dict(d_model=64, n_heads=4, n_kv=2, d_ff=128)
XLA_ARGUMENT_BYTES = {"qwen3-0.6b": 104456, "granite-moe-1b-a400m": 215816}
POINTER_BYTES = 8

_COMMON = """
import dataclasses, json
def jcfg(x):
    return json.dumps(dataclasses.asdict(x), sort_keys=True, default=str)
REDUCE = %r
out = {"archs": {}, "cells": {}, "meshes": {}, "memory": {}, "flops": {}}
""" % (REDUCE,)

_REF = _COMMON + """
from repro.launch import dryrun as d        # 512 forced host devices
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import ARCH_IDS, SHAPES, TrainConfig, applicable, \\
    get_config, reduced
from repro.launch.mesh import make_production_mesh
from repro.models import Model
from repro.sharding import rules as rules_lib
from repro.train import step as step_lib

for arch in ARCH_IDS:
    cfg = d.dryrun_config(arch)
    tcfg, remat = d.tcfg_for(cfg)
    out["archs"][arch] = [jcfg(cfg), jcfg(tcfg), remat, Model(cfg).n_params()]
    for name, shape in SHAPES.items():
        out["cells"][arch + "/" + name] = list(applicable(cfg, shape))
for mp in (False, True):
    m = make_production_mesh(multi_pod=mp)
    out["meshes"][str(mp)] = [list(m.devices.shape), list(m.axis_names)]

mesh = Mesh(np.array(jax.devices()[:16]).reshape(4, 4), ("data", "model"))
S = jax.ShapeDtypeStruct

def memory(jitted, args, fn):
    mem = jitted.lower(*args).compile().memory_analysis()
    n_out = len(jax.tree.leaves(jax.eval_shape(fn, *args)))
    return [mem.argument_size_in_bytes, mem.output_size_in_bytes, n_out]

for arch in ("qwen3-0.6b", "granite-moe-1b-a400m"):
    cfg = reduced(get_config(arch)).replace(**REDUCE)
    model, tcfg = Model(cfg), TrainConfig()
    specs = {"tokens": S((8, 64), jnp.int32), "targets": S((8, 64), jnp.int32),
             "mask": S((8, 64), jnp.float32)}
    fn = step_lib.build_train_step(model, tcfg)
    state_sh = step_lib.state_shardings(model, tcfg, mesh)
    jitted = jax.jit(fn, in_shardings=(
        state_sh, rules_lib.batch_shardings_for(specs, mesh)),
        out_shardings=(state_sh, None))
    out["memory"][arch + "/train"] = memory(
        jitted, (step_lib.abstract_state(model, tcfg), specs), fn)

cfg = reduced(get_config("qwen3-0.6b")).replace(**REDUCE)
model = Model(cfg)
cache_abs = jax.eval_shape(lambda: model.init_cache(8, 64))
cache_sh = rules_lib.cache_shardings(cache_abs, mesh)
specs = {"tokens": S((8, 1), jnp.int32), "pos": S((8,), jnp.int32)}

def decode(params, cache, batch):
    logits, cache, _ = model.apply(params, batch["tokens"], mode="decode",
                                   cache=cache, pos=batch["pos"])
    return logits[:, 0], cache

jitted = jax.jit(decode, in_shardings=(
    rules_lib.param_shardings(model.spec, mesh), cache_sh,
    rules_lib.batch_shardings_for(specs, mesh)), out_shardings=(None, cache_sh))
out["memory"]["qwen3-0.6b/decode"] = memory(
    jitted, (model.abstract(), cache_abs, specs), decode)
print("RESULT " + json.dumps(out))
"""

_PORT = _COMMON + """
import numpy as np, torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import ARCH_IDS, SHAPES, TrainConfig, applicable, \\
    get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as d
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import Model
from repro_torch.train import step as step_lib

torch.set_num_threads(1)
cpu = torch.device("cpu")
for arch in ARCH_IDS:
    cfg = d.dryrun_config(arch)
    tcfg, remat = d.tcfg_for(cfg)
    out["archs"][arch] = [jcfg(cfg), jcfg(tcfg), remat, d.n_params(cfg)]
    for name, shape in SHAPES.items():
        out["cells"][arch + "/" + name] = list(applicable(cfg, shape))
for mp in (False, True):
    m = mesh_lib.make_production_mesh(multi_pod=mp, device="cpu")
    out["meshes"][str(mp)] = [list(m.mesh.shape), list(m.mesh_dim_names)]

mesh = mesh_lib.make_mesh((4, 4), ("data", "model"), "cpu")
meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
for arch in ("qwen3-0.6b", "granite-moe-1b-a400m"):
    cfg = reduced(get_config(arch)).replace(**REDUCE)
    specs = {"tokens": meta((8, 64), torch.int32),
             "targets": meta((8, 64), torch.int32),
             "mask": meta((8, 64), torch.float32)}
    rec = d.run_train(cfg, TrainConfig(), specs, mesh, cpu)
    out["memory"][arch + "/train"] = [rec["memory"]["argument_bytes"],
                                      rec["memory"]["output_bytes"]]
cfg = reduced(get_config("qwen3-0.6b")).replace(**REDUCE)
specs = {"tokens": meta((8, 1), torch.int32), "pos": meta((8,), torch.int32)}
rec = d.run_serve(cfg, ShapeConfig("decode", "decode", 64, 8), specs, mesh,
                  cpu)
out["memory"]["qwen3-0.6b/decode"] = [rec["memory"]["argument_bytes"],
                                      rec["memory"]["output_bytes"]]

rng = np.random.default_rng(0)
for arch in ARCH_IDS:
    cfg, tcfg = reduced(get_config(arch)), TrainConfig()
    toks = rng.integers(0, cfg.vocab, (2, 33)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "targets": torch.from_numpy(toks[:, 1:].copy()),
             "mask": torch.ones(2, 32)}
    dt = getattr(torch, cfg.dtype)
    if cfg.frontend == "audio":
        batch["enc_embeds"] = torch.randn(2, cfg.encoder_len, cfg.d_model,
                                          dtype=dt)
    if cfg.frontend == "vision":
        batch["prefix_embeds"] = torch.randn(2, cfg.frontend_len,
                                             cfg.d_model, dtype=dt)
    pred = d.predict_step(cfg, tcfg, batch, device="cpu")
    model = Model(cfg, device="cpu")
    with FlopCounterMode(display=False) as fc:
        step_lib.build_train_step(model, tcfg)(
            step_lib.init_state(model, tcfg), batch)
    out["flops"][arch] = [pred["flops"], fc.get_total_flops()]
print("RESULT " + json.dumps(out))
"""


def _start(script):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(script)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc):
    try:
        stdout, stderr = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, stdout[-2000:] + "\n" + stderr[-4000:]
    line = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def both():
    """(reference, port) results; the two subprocesses run side by side."""
    ref, port = _start(_REF), _start(_PORT)
    return _result(ref), _result(port)


def test_configs_and_thresholds_equal_the_reference(both):
    ref, port = both
    assert port["archs"].keys() == ref["archs"].keys()
    assert len(port["archs"]) == 10
    for arch, want in ref["archs"].items():
        assert port["archs"][arch] == want, arch


def test_applicable_cells_equal_the_reference(both):
    ref, port = both
    assert len(ref["cells"]) == 40
    assert port["cells"] == ref["cells"]


def test_production_mesh_shapes(both):
    ref, port = both
    assert port["meshes"] == ref["meshes"] == {
        "False": [[16, 16], ["data", "model"]],
        "True": [[2, 16, 16], ["pod", "data", "model"]]}


@pytest.mark.parametrize("cell", ["qwen3-0.6b/train",
                                  "granite-moe-1b-a400m/train",
                                  "qwen3-0.6b/decode"])
def test_argument_and_output_bytes_equal_xla(both, cell):
    ref, port = both
    arg, out, n_out = ref["memory"][cell]
    p_arg, p_out = port["memory"][cell]
    assert p_arg == arg
    arch = cell.split("/")[0]
    if cell.endswith("/train"):
        assert arg == XLA_ARGUMENT_BYTES[arch]
    assert out == p_out + POINTER_BYTES * n_out


def test_predicted_flops_equal_a_real_step(both):
    _, port = both
    assert len(port["flops"]) == 10
    for arch, (pred, real) in port["flops"].items():
        assert real > 0, arch
        assert pred == real, arch


def test_artifacts_exist_and_wellformed():
    """The port's sweep (``launch.dryrun``'s ``artifacts/dryrun_torch``):
    every cell it wrote is ``ok`` or ``skipped``."""
    adir = os.path.join(REPO, "artifacts", "dryrun_torch")
    if not os.path.isdir(adir):
        pytest.skip("no artifacts directory (sweep not run)")
    import glob
    for p in glob.glob(os.path.join(adir, "*.json")):
        with open(p) as f:
            cell = json.load(f)
        assert cell["status"] in ("ok", "skipped"), (p, cell["status"])
