"""The port's checkpoints against the reference's (ROADMAP A14b): the
same files, and each package restores what the other wrote, bit for bit,
for AdamW and Adafactor states; and the reference's checkpoint tests
(``tests/test_fault_tolerance.py``: round trip and GC, async, elastic
restore, exact resume) on the port.

The reference's own ``CheckpointManager.restore`` cannot read a bfloat16
leaf, Adafactor's ``m``, whoever wrote it: ``np.save`` writes
``ml_dtypes``' bfloat16 as raw two-byte ``V2`` words, which ``np.load``
returns as ``V2`` and ``jax.device_put`` rejects.  So for Adafactor the
twin holds the port's files to the reference's byte for byte (the
reference restores them exactly as far as it restores its own) and the
port restores the reference's."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefModelConfig
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.data.synthetic import SyntheticLM as RefSyntheticLM
from repro.models import Model as RefModel
from repro.train import step as ref_step
from repro.train.checkpoint import CheckpointManager as RefManager
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import Model
from repro_torch.models.params import state_from_reference, \
    state_to_reference
from repro_torch.train import step as step_lib
from repro_torch.train.checkpoint import CheckpointManager

from lm_twins import one_torch_thread  # noqa: F401  (autouse)
from lm_twins import tree_np

CFG = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=4,
           n_kv=2, d_ff=64, vocab=128, vocab_pad_multiple=64)


def _bits(x):
    """A leaf's dtype name and raw bytes (bfloat16 as its two-byte words)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy().tobytes()
        return str(x.dtype).replace("torch.", ""), x.numpy().tobytes()
    x = np.asarray(x)
    name = "bfloat16" if x.dtype.name in ("bfloat16", "void16") else \
        x.dtype.name
    return name, x.tobytes()


def _same_bits(a, b):
    la = jax.tree_util.tree_flatten_with_path(a)[0]
    lb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [jax.tree_util.keystr(k) for k, _ in la] == \
        [jax.tree_util.keystr(k) for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert tuple(np.shape(x)) == tuple(np.shape(y)), k
        assert _bits(x) == _bits(y), jax.tree_util.keystr(k)


def _ref_state(opt, steps=1):
    """The reference's state after ``steps`` train steps (non-zero
    optimizer state)."""
    rm = RefModel(RefModelConfig(**CFG))
    rt = RefTrainConfig(learning_rate=1e-3, warmup_steps=0, optimizer=opt)
    st = ref_step.init_state(rm, jax.random.PRNGKey(0), rt)
    fn = jax.jit(ref_step.build_train_step(rm, rt))
    data = RefSyntheticLM(vocab=128, seq_len=16, global_batch=2, seed=1)
    for i in range(steps):
        st, _ = fn(st, {k: jnp.asarray(v) for k, v in
                        data.batch_at(i).items()})
    return st, TrainConfig(optimizer=opt)


def _port_state(ref_state):
    return state_from_reference(Model(ModelConfig(**CFG), device="cpu"),
                                tree_np(ref_state))


def _read_dir(path):
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    files = {leaf["file"]: _bits(np.load(os.path.join(path, leaf["file"])))
             for leaf in meta["leaves"]}
    return meta, files


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_port_files_equal_the_reference_files(opt, tmp_path):
    rs, _ = _ref_state(opt)
    RefManager(str(tmp_path / "ref")).save(rs, 3, blocking=True)
    CheckpointManager(str(tmp_path / "port")).save(_port_state(rs), 3,
                                                   blocking=True)
    want = _read_dir(tmp_path / "ref" / "step_00000003")
    got = _read_dir(tmp_path / "port" / "step_00000003")
    assert got[0] == want[0]                     # meta.json, key for key
    assert sorted(os.listdir(tmp_path / "port" / "step_00000003")) == \
        sorted(os.listdir(tmp_path / "ref" / "step_00000003"))
    assert got[1] == want[1]                     # every leaf, bit for bit
    keys = [leaf["key"] for leaf in got[0]["leaves"]]
    assert "params/layers/layer0/attn/attn/wq" in keys
    assert "opt/count" in keys and "step" in keys
    if opt == "adafactor":
        assert "opt/v/embed/table/[0]" in keys


def test_reference_restores_port_checkpoints(tmp_path):
    rs, _ = _ref_state("adamw")
    ps = _port_state(rs)
    CheckpointManager(str(tmp_path)).save(ps, 5, blocking=True)
    restored, step = RefManager(str(tmp_path)).restore(
        jax.eval_shape(lambda: rs))
    assert step == 5
    _same_bits(tree_np(restored), state_to_reference(ps))


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_port_restores_reference_checkpoints(opt, tmp_path):
    rs, tcfg = _ref_state(opt)
    RefManager(str(tmp_path)).save(rs, 7, blocking=True)
    model = Model(ModelConfig(**CFG), device="cpu")
    tree, step = CheckpointManager(str(tmp_path)).restore(
        step_lib.abstract_state(model, tcfg), device="cpu")
    assert step == 7
    _same_bits(tree, tree_np(rs))
    _same_bits(state_to_reference(state_from_reference(model, tree)),
               tree_np(rs))


def test_reference_cannot_restore_bfloat16_leaves(tmp_path):
    """The reference's fault the module docstring names, on its own
    Adafactor checkpoint."""
    rs, _ = _ref_state("adafactor")
    mgr = RefManager(str(tmp_path))
    mgr.save(rs, 1, blocking=True)
    with pytest.raises(TypeError, match="V2"):
        mgr.restore(jax.eval_shape(lambda: rs))


def _state(opt="adamw", seed=0):
    tcfg = TrainConfig(optimizer=opt)
    model = Model(ModelConfig(**CFG), device="cpu", seed=seed)
    return step_lib.init_state(model, tcfg), tcfg


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_checkpoint_roundtrip_and_gc(opt, tmp_path):
    state, tcfg = _state(opt)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(state, s, blocking=True)
    assert mgr.all_steps() == [3, 4]        # gc keeps last 2
    restored, step = mgr.restore(
        step_lib.abstract_state(state["params"], tcfg), device="cpu")
    assert step == 4
    _same_bits(restored, state_to_reference(state))


def test_async_checkpoint(tmp_path):
    state, _ = _state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, 7, blocking=False)      # background thread
    mgr.wait()
    assert mgr.latest_step() == 7
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_async_save_copies_the_state_first(tmp_path):
    """The training loop updates the state in place while the writer
    thread runs: the checkpoint holds the state as it was at ``save``."""
    state, tcfg = _state("adafactor")
    want = state_to_reference(state)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, 3, blocking=False)
    with torch.no_grad():
        for p in state["params"].parameters():
            p.add_(1.0)
        for leaf in jax.tree.leaves(state["opt"]):
            leaf.add_(1)
    mgr.wait()
    restored, _ = mgr.restore(
        step_lib.abstract_state(state["params"], tcfg), device="cpu")
    _same_bits(restored, want)


def test_elastic_restore_resharding(tmp_path):
    """Checkpoints are logical arrays: restoring into a fresh model on
    any device reproduces identical values."""
    state, tcfg = _state(seed=1)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, 5, blocking=True)
    other = Model(ModelConfig(**CFG), device="cpu", seed=2)
    tree, _ = mgr.restore(step_lib.abstract_state(other, tcfg),
                          device="cpu")
    _same_bits(state_to_reference(state_from_reference(other, tree)),
               state_to_reference(state))


def test_restore_rejects_a_checkpoint_of_other_shapes(tmp_path):
    state, tcfg = _state()
    CheckpointManager(str(tmp_path)).save(state, 1, blocking=True)
    wider = Model(ModelConfig(**dict(CFG, d_model=64)), device="meta")
    with pytest.raises(ValueError, match="shape"):
        CheckpointManager(str(tmp_path)).restore(
            step_lib.abstract_state(wider, tcfg), device="cpu")


def test_train_resume_is_exact(tmp_path):
    """25 straight steps == 15 steps + checkpoint + resume + 10 steps."""
    tcfg = TrainConfig(learning_rate=1e-3)
    data = SyntheticLM(vocab=128, seq_len=32, global_batch=4, seed=9)

    def run(state, lo, hi):
        fn = step_lib.build_train_step(state["params"], tcfg)
        for i in range(lo, hi):
            batch = {k: torch.from_numpy(v)
                     for k, v in data.batch_at(i).items()}
            state, _ = fn(state, batch)
        return state

    def fresh():
        return step_lib.init_state(
            Model(ModelConfig(**CFG), device="cpu", seed=2), tcfg)

    s_straight = run(fresh(), 0, 25)
    s_mid = run(fresh(), 0, 15)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(s_mid, 15, blocking=True)
    model = Model(ModelConfig(**CFG), device="cpu", seed=3)
    tree, step = mgr.restore(step_lib.abstract_state(model, tcfg),
                             device="cpu")
    s_resumed = run(state_from_reference(model, tree), step, 25)
    a = jax.tree.leaves(state_to_reference(s_straight))
    b = jax.tree.leaves(state_to_reference(s_resumed))
    for x, y in zip(a, b):
        assert np.allclose(x.numpy(), y.numpy(), atol=1e-6)
