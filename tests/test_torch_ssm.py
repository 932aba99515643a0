"""The port's recurrent blocks against the reference's (ROADMAP A14a), and
each test of ``tests/test_ssm.py`` on the port alone.

Twins: ``mamba_block`` (from zero state and from a carried state, with a
length the chunk does not divide), ``mamba_ref``, ``mlstm_block`` and its
carry, ``mlstm_inner``, ``mlstm_ref_inner``, ``slstm_block`` and the three
decode steps.  The port's chunk scan is a log-depth Hillis–Steele scan,
the reference's ``lax.associative_scan``: the same combine, other
roundings.  Tolerance (``lm_twins``): float32 max |port - ref| <= 1e-4 *
max |ref|."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefModelConfig
from repro.configs.base import SSMConfig as RefSSMConfig
from repro.models import ssm as rssm
from repro.models.params import init_params as ref_init_params
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.models import ssm
from repro_torch.models.params import init_params

from lm_twins import one_torch_thread  # noqa: F401  (autouse)
from lm_twins import assert_close, j, t, tree_torch

_KW = dict(name="t", family="ssm", n_layers=1, d_model=32, n_heads=4,
           n_kv=4, d_ff=0, vocab=64)
CFG = ModelConfig(**_KW, ssm=SSMConfig(d_state=8, expand=2.0, chunk=8))
REF_CFG = RefModelConfig(**_KW, ssm=RefSSMConfig(d_state=8, expand=2.0,
                                                  chunk=8))


def _x(seed, shape, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _params(spec_fn, seed=0):
    rp = ref_init_params(spec_fn(REF_CFG), jax.random.PRNGKey(seed))
    return rp, tree_torch(rp)


# ----------------------------------------------------------------- twins

@pytest.mark.parametrize("s", [32, 27])
def test_mamba_block_twin(s):
    rp, pp = _params(rssm.mamba_spec)
    x = _x(1, (2, s, 32))
    ry, (rh, rconv) = jax.jit(lambda p, x: rssm.mamba_block(
        p, x, REF_CFG, return_state=True))(rp, j(x))
    py, (ph, pconv) = ssm.mamba_block(pp, t(x), CFG, return_state=True)
    assert_close(py, ry, what="y")
    assert_close(ph, rh, what="h")
    assert_close(pconv, rconv, what="conv")
    assert_close(ssm.mamba_ref(pp, t(x), CFG), rssm.mamba_ref(rp, j(x),
                                                              REF_CFG),
                 what="mamba_ref")


def test_mamba_block_twin_from_state():
    """A second segment from the first one's state, and one decode step."""
    rp, pp = _params(rssm.mamba_spec)
    x0, x1, x2 = _x(2, (2, 12, 32)), _x(3, (2, 9, 32)), _x(4, (2, 1, 32))
    _, rst = rssm.mamba_block(rp, j(x0), REF_CFG, return_state=True)
    _, pst = ssm.mamba_block(pp, t(x0), CFG, return_state=True)
    ry, rst = rssm.mamba_block(rp, j(x1), REF_CFG, state=rst,
                               return_state=True)
    py, pst = ssm.mamba_block(pp, t(x1), CFG, state=pst, return_state=True)
    assert_close(py, ry, what="segment")
    ry, rst = rssm.mamba_decode(rp, j(x2), REF_CFG, rst)
    py, pst = ssm.mamba_decode(pp, t(x2), CFG, pst)
    assert_close(py, ry, what="decode")
    assert_close(pst[0], rst[0], what="h")
    assert_close(pst[1], rst[1], what="conv")


def test_mlstm_block_twin():
    rp, pp = _params(rssm.mlstm_spec)
    x = _x(5, (2, 20, 32))
    ry, rc = jax.jit(lambda p, x: rssm.mlstm_block(
        p, x, REF_CFG, return_state=True))(rp, j(x))
    py, pc = ssm.mlstm_block(pp, t(x), CFG, return_state=True)
    assert_close(py, ry, what="y")
    for name, a, b in zip("cnm", pc, rc):
        assert_close(a, b, what=name)
    # decode steps from the carried state
    for step in range(3):
        xs = _x(6 + step, (2, 1, 32))
        ry, rc = rssm.mlstm_decode(rp, j(xs), REF_CFG, rc)
        py, pc = ssm.mlstm_decode(pp, t(xs), CFG, pc)
        assert_close(py, ry, what=f"decode {step}")
    for name, a, b in zip("cnm", pc, rc):
        assert_close(a, b, what=name)


def _gates(seed, b, s, h, hd, f_scale=2.0, i_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    lf = np.asarray(jax.nn.log_sigmoid(
        rng.standard_normal((b, s, h)).astype(np.float32) * f_scale))
    li = (rng.standard_normal((b, s, h)) * i_scale).astype(np.float32)
    return q, k, v, lf, li


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_mlstm_inner_twin(chunk):
    q, k, v, lf, li = _gates(9, 2, 30, 4, 8)
    rh, rc = rssm.mlstm_inner(j(q), j(k), j(v), j(lf), j(li), chunk=chunk)
    ph, pc = ssm.mlstm_inner(t(q), t(k), t(v), t(lf), t(li), chunk=chunk)
    assert_close(ph, rh, what="h")
    for name, a, b in zip("cnm", pc, rc):
        assert_close(a, b, what=name)
    assert_close(ssm.mlstm_ref_inner(t(q), t(k), t(v), t(lf), t(li)),
                 rssm.mlstm_ref_inner(j(q), j(k), j(v), j(lf), j(li)),
                 what="ref_inner")


def test_slstm_block_twin():
    rp, pp = _params(rssm.slstm_spec)
    x = _x(10, (2, 10, 32))
    ry, rst = jax.jit(lambda p, x: rssm.slstm_block(
        p, x, REF_CFG, return_state=True))(rp, j(x))
    py, pst = ssm.slstm_block(pp, t(x), CFG, return_state=True)
    assert_close(py, ry, what="y")
    for name, a, b in zip(("c", "n", "h", "m"), pst, rst):
        assert_close(a, b, what=name)
    xs = _x(11, (2, 1, 32))
    ry, rst = rssm.slstm_decode(rp, j(xs), REF_CFG, rst)
    py, pst = ssm.slstm_decode(pp, t(xs), CFG, pst)
    assert_close(py, ry, what="decode")


def test_assoc_scan_is_the_recurrence():
    rng = np.random.default_rng(12)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 13, 3)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((2, 13, 3)).astype(np.float32))
    acum, ucum = ssm.assoc_scan(a, u)
    h = torch.zeros(2, 3)
    prod = torch.ones(2, 3)
    for step in range(13):
        h = a[:, step] * h + u[:, step]
        prod = prod * a[:, step]
        assert torch.allclose(ucum[:, step], h, atol=1e-5)
        assert torch.allclose(acum[:, step], prod, atol=1e-6)


# ------------------------------------------- the reference's properties

def _port_params(spec_fn, cfg=CFG, seed=0):
    return init_params(spec_fn(cfg), seed=seed)


def test_mamba_chunked_matches_sequential():
    p = _port_params(ssm.mamba_spec)
    x = t(_x(1, (2, 32, 32)))
    got = ssm.mamba_block(p, x, CFG)
    want = ssm.mamba_ref(p, x, CFG)
    assert float(torch.max(torch.abs(got - want))) < 1e-4


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_mamba_chunk_invariance(chunk):
    cfg = CFG.replace(ssm=SSMConfig(d_state=8, expand=2.0, chunk=chunk))
    p = _port_params(ssm.mamba_spec, cfg)
    x = t(_x(1, (2, 32, 32)))
    base = ssm.mamba_ref(p, x, cfg)
    assert float(torch.max(torch.abs(ssm.mamba_block(p, x, cfg) - base))) \
        < 1e-4


def test_mamba_nondivisible_length():
    p = _port_params(ssm.mamba_spec)
    x = t(_x(1, (2, 27, 32)))
    got = ssm.mamba_block(p, x, CFG)
    want = ssm.mamba_ref(p, x, CFG)
    assert float(torch.max(torch.abs(got - want))) < 1e-4


def test_mamba_decode_matches_train():
    p = _port_params(ssm.mamba_spec)
    x = t(_x(1, (2, 12, 32)))
    full = ssm.mamba_block(p, x, CFG)
    st = None
    outs = []
    for step in range(12):
        if st is None:
            o, st = ssm.mamba_block(p, x[:, :1], CFG, return_state=True)
        else:
            o, st = ssm.mamba_decode(p, x[:, step:step + 1], CFG, st)
        outs.append(o)
    dec = torch.cat(outs, dim=1)
    assert float(torch.max(torch.abs(dec - full))) < 1e-4


def test_mlstm_chunkwise_matches_sequential():
    q, k, v, lf, li = (t(a) for a in _gates(0, 2, 32, 4, 8))
    got, _ = ssm.mlstm_inner(q, k, v, lf, li, chunk=8)
    want = ssm.mlstm_ref_inner(q, k, v, lf, li)
    assert float(torch.max(torch.abs(got - want))) < 1e-3


@pytest.mark.parametrize("chunk", [4, 16, 32])
def test_mlstm_chunk_invariance(chunk):
    q, k, v, lf, li = (t(a) for a in _gates(7, 1, 32, 2, 8, f_scale=1.0))
    want = ssm.mlstm_ref_inner(q, k, v, lf, li)
    got, _ = ssm.mlstm_inner(q, k, v, lf, li, chunk=chunk)
    assert float(torch.max(torch.abs(got - want))) < 1e-3


def test_mlstm_extreme_gates_stable():
    """Exponential input gates with large pre-activations must not NaN."""
    q, k, v, lf, li = (t(a) for a in _gates(3, 1, 16, 2, 8, f_scale=10.0,
                                            i_scale=20.0))
    got, _ = ssm.mlstm_inner(q, k, v, lf, li, chunk=4)
    assert bool(torch.all(torch.isfinite(got)))


def test_slstm_decode_matches_scan():
    p = _port_params(ssm.slstm_spec)
    x = t(_x(1, (2, 10, 32)))
    full = ssm.slstm_block(p, x, CFG)
    st = None
    outs = []
    for step in range(10):
        o, st = ssm.slstm_block(p, x[:, step:step + 1], CFG, state=st,
                                return_state=True)
        outs.append(o)
    dec = torch.cat(outs, dim=1)
    assert float(torch.max(torch.abs(dec - full))) < 1e-4
