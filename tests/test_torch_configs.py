"""The port's configs, shapes and parameter specs against the reference's
(ROADMAP A14a): every field, every reduced config, the 40 (arch, shape)
input-spec cells with their verdicts, full-size parameter counts and the
logical-axes tree, all exactly.  Nothing is allocated at full size: the
port's models are built on the ``meta`` device."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro import configs as ref_configs
from repro.models import transformer as ref_transformer
from repro.models.params import count_params as ref_count_params
from repro.models.params import spec_axes as ref_spec_axes
from repro_torch import configs
from repro_torch.models import Model, transformer
from repro_torch.models.params import count_params, spec_axes

from lm_twins import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ref_configs.ARCH_IDS


def test_arch_ids_equal():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _plain(cfg):
    """A config as nested plain values (sub-configs as dicts)."""
    out = {}
    for k, v in _fields(cfg).items():
        out[k] = _fields(v) if dataclasses.is_dataclass(v) else v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_config_field_for_field(arch):
    ref, port = ref_configs.get_config(arch), configs.get_config(arch)
    assert _plain(port) == _plain(ref)
    for prop in ("hd", "padded_vocab", "pattern_period", "n_reps"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.sub_quadratic() == ref.sub_quadratic()


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_field_for_field(arch):
    ref = ref_configs.reduced(ref_configs.get_config(arch))
    port = configs.reduced(configs.get_config(arch))
    assert _plain(port) == _plain(ref)
    # the reference's own property of reduced configs, on the port
    full = configs.get_config(arch)
    assert port.family == full.family
    assert port.block_pattern == full.block_pattern
    assert (port.moe is None) == (full.moe is None)
    assert (port.ssm is None) == (full.ssm is None)
    assert port.cross_attention == full.cross_attention


def test_shape_and_train_configs_equal():
    assert {k: _fields(v) for k, v in configs.SHAPES.items()} == \
        {k: _fields(v) for k, v in ref_configs.SHAPES.items()}
    assert _fields(configs.TrainConfig()) == _fields(ref_configs.TrainConfig())


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        configs.get_config("nope")


CELLS = [(a, s) for a in ARCHS for s in ref_configs.SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_and_applicable(arch, shape):
    rcfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    rshape, pshape = ref_configs.SHAPES[shape], configs.SHAPES[shape]
    assert configs.applicable(cfg, pshape) == \
        ref_configs.applicable(rcfg, rshape)
    assert configs.token_count(cfg, pshape) == \
        ref_configs.token_count(rcfg, rshape)
    ref = ref_configs.input_specs(rcfg, rshape)
    port = configs.input_specs(cfg, pshape)
    assert set(port) == set(ref)
    for k, r in ref.items():
        p = port[k]
        assert p.device.type == "meta", k
        assert tuple(p.shape) == tuple(r.shape), k
        assert str(p.dtype).replace("torch.", "") == jnp.dtype(r.dtype).name, k
    small = configs.input_specs(cfg, pshape, batch=3)
    assert all(v.shape[0] == 3 for v in small.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_param_count(arch):
    """Spec arithmetic and the meta-device modules, nothing allocated."""
    rcfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    want = ref_count_params(ref_transformer.lm_spec(rcfg))
    model = Model(cfg, device="meta")
    assert model.n_params() == want
    assert count_params(transformer.lm_spec(cfg)) == want
    assert sum(p.numel() for p in model.parameters()) == want
    assert all(p.device.type == "meta" for p in model.parameters())
    assert all(p.dtype == getattr(torch, cfg.param_dtype)
               for p in model.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_axes_equal(arch):
    rcfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    assert spec_axes(transformer.lm_spec(cfg)) == \
        ref_spec_axes(ref_transformer.lm_spec(rcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_shapes(arch):
    cfg = configs.get_config(arch)
    model = Model(cfg, device="meta")
    abstract = model.abstract()
    rabstract = ref_transformer.lm_spec(ref_configs.get_config(arch))

    def walk(a, r):
        if isinstance(r, dict):
            assert set(a) == set(r)
            for k in r:
                walk(a[k], r[k])
            return
        assert a.device.type == "meta" and tuple(a.shape) == r.shape
    walk(abstract, rabstract)
