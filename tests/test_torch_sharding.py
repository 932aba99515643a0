"""The port's sharding rules against the reference's (ROADMAP A14b): the
``rules`` cases of ``tests/test_sharding_hlo.py`` on the port, and for
every leaf of every architecture's spec (full and ``reduced``) the port's
specs equal to the reference's ``PartitionSpec``s entry for entry on
duck-typed meshes: parameters, the train state's shardings (as
placements), batches and caches; then the placements on a one-rank
``gloo`` ``DeviceMesh`` from ``launch.mesh.make_local_mesh``.

The reference runs on ``jax.sharding.AbstractMesh``es (which its
``NamedSharding``s accept without devices), the port on ``FakeMesh``es
of the same axis sizes.  The reference's caches are stacked ``(reps, B,
...)``; each of the port's per-repetition cache leaves takes the stacked
leaf's spec without its leading ``None``."""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ARCH_IDS
from repro.configs import TrainConfig as RefTrainConfig
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import Model as RefModel
from repro.models.params import map_spec as ref_map_spec
from repro.sharding import rules as ref_rules
from repro.train import step as ref_step
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import Model, transformer
from repro_torch.models.params import leaves
from repro_torch.sharding import rules
from repro_torch.train import step as step_lib

from lm_twins import one_torch_thread  # noqa: F401  (autouse)


class FakeMesh:
    """Duck-typed mesh exposing .shape mapping (enough for spec_for)."""
    def __init__(self, shape):
        self.shape = shape


MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 4, "model": 2}, {"data": 2}]


def _pair(shape):
    return (AbstractMesh(tuple(shape.values()), tuple(shape)),
            FakeMesh(dict(shape)))


def _cfgs(arch):
    return [(ref_get_config(arch), get_config(arch)),
            (ref_reduced(ref_get_config(arch)), reduced(get_config(arch)))]


def _spec_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, (NamedSharding, rules.Spec)))


def test_spec_divisibility_fallback():
    mesh = FakeMesh({"data": 16, "model": 16})
    # divisible everywhere
    assert rules.spec_for((1024, 3072), ("embed", "mlp"), mesh) == \
        ("data", "model")
    # 25 heads don't divide 16 -> replicated on that dim
    assert rules.spec_for((1600, 25, 64), ("embed", "heads", None),
                          mesh) == ("data", None, None)
    # odd vocab falls back
    assert rules.spec_for((49155, 64), ("vocab", "embed"), mesh) == \
        (None, "data")


def test_spec_no_axis_reuse():
    mesh = FakeMesh({"data": 16, "model": 16})
    # both dims want 'model': only the first gets it
    assert rules.spec_for((32, 64), ("heads", "mlp"), mesh) == \
        ("model", None)


def test_layers_axis_never_sharded():
    mesh = FakeMesh({"data": 16, "model": 16})
    spec = rules.spec_for((48, 1024, 3072), ("layers", "embed", "mlp"),
                          mesh)
    assert spec == (None, "data", "model")


def test_batch_sharding_fallback_small_batch():
    mesh = FakeMesh({"data": 16, "model": 16})
    assert rules.dp_axes(mesh) == ("data",)
    assert rules.batch_sharding(mesh, 2, 1) == (None, None)
    assert rules.batch_sharding(mesh, 2, 256) == ("data", None)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch):
    for shape in MESHES:
        amesh, fmesh = _pair(shape)
        for rcfg, cfg in _cfgs(arch):
            ref_spec = RefModel(rcfg).spec
            want = ref_map_spec(lambda p: ref_rules.spec_for(
                p.shape, p.axes, amesh), ref_spec)
            got = rules.param_shardings(transformer.lm_spec(cfg), fmesh)
            flat_w = _spec_leaves(want)
            flat_g = _spec_leaves(got)
            assert len(flat_w) == len(flat_g)
            for w, g in zip(flat_w, flat_g):
                assert isinstance(g, rules.Spec)
                assert tuple(w) == tuple(g), (arch, shape, w, g)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_state_shardings_equal_the_reference(arch, opt):
    for shape in MESHES[:2]:
        amesh, fmesh = _pair(shape)
        rcfg, cfg = _cfgs(arch)[1]
        want = ref_step.state_shardings(RefModel(rcfg),
                                        RefTrainConfig(optimizer=opt), amesh)
        got = step_lib.state_shardings(Model(cfg, device="meta"),
                                       TrainConfig(optimizer=opt), fmesh)
        flat_w = jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
        # a leaf of ``got`` is a tuple of placements, one per mesh dim
        flat_g = jax.tree_util.tree_flatten_with_path(
            got, is_leaf=lambda x: isinstance(x, tuple) and len(x) == len(
                shape) and not any(isinstance(e, tuple) for e in x))[0]
        assert [jax.tree_util.keystr(k) for k, _ in flat_w] == \
            [jax.tree_util.keystr(k) for k, _ in flat_g]
        for (k, w), (_, g) in zip(flat_w, flat_g):
            assert rules.placements(rules.Spec(tuple(w.spec)), fmesh) == g, \
                (arch, jax.tree_util.keystr(k))


@pytest.mark.parametrize("shape", MESHES)
def test_batch_shardings_equal_the_reference(shape):
    amesh, fmesh = _pair(shape)
    for ndim in (1, 2, 3):
        for b in (None, 1, 2, 6, 64, 256):
            want = ref_rules.batch_sharding(amesh, ndim, b).spec
            assert tuple(want) == rules.batch_sharding(fmesh, ndim, b)
    specs = {"tokens": jax.ShapeDtypeStruct((64, 128), np.int32),
             "enc_embeds": jax.ShapeDtypeStruct((64, 30, 8), np.float32),
             "one": jax.ShapeDtypeStruct((1, 8), np.int32)}
    want = ref_rules.batch_shardings_for(specs, amesh)
    got = rules.batch_shardings_for(specs, fmesh)
    assert {k: tuple(v.spec) for k, v in want.items()} == got
    assert rules.replicated(fmesh) == tuple(ref_rules.replicated(amesh).spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings_equal_the_reference(arch):
    rcfg, cfg = _cfgs(arch)[1]
    for batch, clen in ((2, 16), (32, 64)):
        ref_cache = jax.eval_shape(lambda: RefModel(rcfg).init_cache(
            batch, clen))
        port_cache = transformer.init_cache(cfg, batch, clen, "meta")
        for shape in MESHES:
            amesh, fmesh = _pair(shape)
            want = ref_rules.cache_shardings(ref_cache, amesh)
            got = rules.cache_shardings(port_cache, fmesh)
            assert len(got) == cfg.n_reps
            for r, unit in enumerate(got):
                flat_w = jax.tree_util.tree_flatten_with_path(
                    want, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
                flat_g = jax.tree_util.tree_flatten_with_path(
                    unit, is_leaf=lambda x: isinstance(x, rules.Spec))[0]
                assert [jax.tree_util.keystr(k) for k, _ in flat_w] == \
                    [jax.tree_util.keystr(k) for k, _ in flat_g]
                for (k, w), (_, g) in zip(flat_w, flat_g):
                    assert len(w.spec) == 0 or w.spec[0] is None
                    assert tuple(w.spec)[1:] == tuple(g), \
                        (arch, shape, jax.tree_util.keystr(k))


def test_param_specs_drop_the_layers_entry():
    cfg = reduced(get_config("qwen3-0.6b"))
    model = Model(cfg, device="meta")
    fmesh = FakeMesh({"data": 16, "model": 4})
    specs = rules.param_specs(model, fmesh)
    assert set(specs) == {n for n, _ in model.named_parameters()}
    stacked = dict(("/".join(path), rules.spec_for(p.shape, p.axes, fmesh))
                   for path, p in leaves(model.spec))
    name = "layers.1.layer0.attn.attn.wq"
    assert specs[name] == stacked["layers/layer0/attn/attn/wq"][1:]
    assert specs["embed.table"] == stacked["embed/table"]
    for name, t in model.named_parameters():
        assert len(specs[name]) == t.dim(), name


@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_placements_on_a_one_rank_device_mesh(one_rank_group):
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    mesh = mesh_lib.make_local_mesh(model_axis=1, device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert rules.axis_sizes(mesh) == {"data": 1, "model": 1}
    assert rules.dp_axes(mesh) == ("data",)
    spec = rules.spec_for((64, 128), ("embed", "mlp"), mesh)
    assert spec == ("data", "model")
    assert rules.placements(spec, mesh) == (Shard(0), Shard(1))
    assert rules.placements(rules.Spec((None, "data")), mesh) == \
        (Shard(1), Replicate())
    assert rules.placements(rules.replicated(mesh), mesh) == \
        (Replicate(), Replicate())
    x = torch.arange(64 * 128, dtype=torch.float32).reshape(64, 128)
    d = distribute_tensor(x, mesh, rules.placements(spec, mesh))
    assert torch.equal(d.full_tensor(), x)
    cfg = reduced(get_config("qwen3-0.6b"))
    model = Model(cfg, device="cpu")
    for name, t in model.named_parameters():
        pl = rules.placements(rules.param_specs(model, mesh)[name], mesh)
        assert torch.equal(distribute_tensor(t.detach(), mesh,
                                             pl).full_tensor(), t), name
    with pytest.raises(ValueError, match="model axis"):
        mesh_lib.make_local_mesh(model_axis=3, device="cpu")
