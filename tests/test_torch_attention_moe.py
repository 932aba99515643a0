"""The port's attention and MoE dispatch against the reference's
(ROADMAP A14a), and each property of ``tests/test_attention_moe.py`` on
the port alone.

Twins: ``full_attention``, ``chunked_attention`` (with fully masked kv
blocks), ``decode_attention``, ``decode_window_attention``, the cache
writes (a write past the end clamps to the last slot, as
``lax.dynamic_update_slice`` does), ``moe_block`` (routing exactly, then
``y`` and ``aux_loss``) and ``moe_ref``.  Tolerances (``lm_twins``):
float32 max |port - ref| <= 1e-4 * max |ref|; routing and cache slots
exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import ModelConfig as RefModelConfig
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.models import attention as RA
from repro.models import moe as rmoe
from repro.models.params import init_params as ref_init_params
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import attention as A
from repro_torch.models import moe
from repro_torch.models.params import init_params

from lm_twins import one_torch_thread  # noqa: F401  (autouse)
from lm_twins import F32_TOL, assert_close, j, t, to_np, tree_torch


def _qkv(seed, b=2, s=64, h=4, kh=2, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, hd)).astype(np.float32)
    return q, k, v


def _tq(q, k, v):
    return t(q), t(k), t(v)


# ----------------------------------------------------------------- twins

@pytest.mark.parametrize("window", [None, 12])
def test_full_attention_twin(window):
    q, k, v = _qkv(10, h=8, kh=2)
    ref = RA.full_attention(j(q), j(k), j(v), causal=True, window=window)
    port = A.full_attention(*_tq(q, k, v), causal=True, window=window)
    assert_close(port, ref, what="full")
    ref = RA.full_attention(j(q), j(k), j(v), causal=False)
    port = A.full_attention(*_tq(q, k, v), causal=False)
    assert_close(port, ref, what="bidirectional")


@pytest.mark.parametrize("chunk,window", [(8, None), (8, 12), (16, 12),
                                          (32, None)])
def test_chunked_attention_twin(chunk, window):
    """window 12 with chunk 8: the first kv blocks of the last query
    chunks are fully masked, which -1e30 (not -inf) keeps finite."""
    q, k, v = _qkv(11)
    ref = RA.chunked_attention(j(q), j(k), j(v), causal=True, chunk=chunk,
                               window=window)
    port = A.chunked_attention(*_tq(q, k, v), causal=True, chunk=chunk,
                               window=window)
    assert_close(port, ref, what="chunked")


def test_decode_attention_twin():
    q, k, v = _qkv(12)
    pos = np.array([10, 63], np.int32)
    qd = np.stack([q[b, p] for b, p in enumerate(pos)])[:, None]
    for window in (None, 8):
        ref = RA.decode_attention(j(qd), j(k), j(v), j(pos), window=window)
        port = A.decode_attention(t(qd), t(k), t(v), t(pos), window=window)
        assert_close(port, ref, what=f"decode window={window}")


def test_cache_writes_twin_with_clamp():
    """Positions past the end clamp to the last slot in both packages."""
    rng = np.random.default_rng(13)
    b, smax, kh, hd = 4, 8, 2, 4
    kc = rng.standard_normal((b, smax, kh, hd)).astype(np.float32)
    vc = rng.standard_normal((b, smax, kh, hd)).astype(np.float32)
    kn = rng.standard_normal((b, 1, kh, hd)).astype(np.float32)
    vn = rng.standard_normal((b, 1, kh, hd)).astype(np.float32)
    pos = np.array([0, 5, 8, 20], np.int32)          # 8 and 20 clamp to 7
    rk, rv = RA.update_cache(j(kc), j(vc), j(kn), j(vn), j(pos))
    pk, pv = A.update_cache(t(kc), t(vc), t(kn), t(vn), t(pos))
    assert np.array_equal(to_np(pk), np.asarray(rk))
    assert np.array_equal(to_np(pv), np.asarray(rv))
    assert np.array_equal(to_np(pk)[3, 7], kn[3, 0])
    assert np.array_equal(to_np(pk)[3, :7], kc[3, :7])
    # out of place: the inputs are left as they were
    pk0 = t(kc)
    A.update_cache(pk0, t(vc), t(kn), t(vn), t(pos))
    assert np.array_equal(pk0.numpy(), kc)
    # ring buffer: slot = pos % window
    rk, rv = RA.update_window_cache(j(kc), j(vc), j(kn), j(vn), j(pos))
    pk, pv = A.update_window_cache(t(kc), t(vc), t(kn), t(vn), t(pos))
    assert np.array_equal(to_np(pk), np.asarray(rk))
    assert np.array_equal(to_np(pv), np.asarray(rv))


def test_decode_window_attention_twin():
    q, k, v = _qkv(14)
    win = 16
    b = q.shape[0]
    rk = jnp.zeros((b, win) + k.shape[2:])
    rv = jnp.zeros((b, win) + v.shape[2:])
    pk = torch.zeros((b, win) + k.shape[2:])
    pv = torch.zeros((b, win) + v.shape[2:])
    for step in range(40):
        pos = np.full((b,), step, np.int32)
        rk, rv = RA.update_window_cache(rk, rv, j(k[:, step:step + 1]),
                                        j(v[:, step:step + 1]), j(pos))
        pk, pv = A.update_window_cache(pk, pv, t(k[:, step:step + 1]),
                                       t(v[:, step:step + 1]), t(pos))
        if step in (3, 15, 16, 39):
            ref = RA.decode_window_attention(j(q[:, step:step + 1]), rk, rv,
                                             j(pos), win)
            port = A.decode_window_attention(t(q[:, step:step + 1]), pk, pv,
                                              t(pos), win)
            assert_close(port, ref, what=f"window step {step}")
    assert np.array_equal(pk.numpy(), np.asarray(rk))


# ------------------------------------------- the reference's properties

@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
@pytest.mark.parametrize("window", [None, 12])
def test_chunked_equals_full(chunk, window):
    q, k, v = _tq(*_qkv(0))
    a = A.full_attention(q, k, v, causal=True, window=window)
    b = A.chunked_attention(q, k, v, causal=True, chunk=chunk, window=window)
    assert float(torch.max(torch.abs(a - b))) < 2e-5


def test_gqa_grouping_matches_repeated_heads():
    q, k, v = _tq(*_qkv(1, h=8, kh=2))
    a = A.full_attention(q, k, v, causal=True)
    b = A.full_attention(q, torch.repeat_interleave(k, 4, dim=2),
                         torch.repeat_interleave(v, 4, dim=2), causal=True)
    assert float(torch.max(torch.abs(a - b))) < 2e-5


def test_decode_matches_full_last_position():
    q, k, v = _tq(*_qkv(2))
    d = A.decode_attention(q[:, -1:], k, v, torch.tensor([63, 63]))
    f = A.full_attention(q, k, v, causal=True)[:, -1:]
    assert float(torch.max(torch.abs(d - f))) < 2e-5


def test_decode_per_slot_positions():
    q, k, v = _tq(*_qkv(3))
    positions = [10, 40]
    q_dec = torch.stack([q[b, p] for b, p in enumerate(positions)])[:, None]
    d = A.decode_attention(q_dec, k, v, torch.tensor(positions))
    for b, p in enumerate(positions):
        f = A.full_attention(q[b:b + 1, p:p + 1], k[b:b + 1, :p + 1],
                             v[b:b + 1, :p + 1], causal=True, q_offset=p)
        assert float(torch.max(torch.abs(d[b] - f[0]))) < 2e-5


def test_ring_buffer_window_decode():
    q, k, v = _tq(*_qkv(4))
    win = 16
    b = q.shape[0]
    kr = torch.zeros((b, win) + k.shape[2:])
    vr = torch.zeros((b, win) + v.shape[2:])
    for step in range(64):
        kr, vr = A.update_window_cache(kr, vr, k[:, step:step + 1],
                                       v[:, step:step + 1],
                                       torch.full((b,), step))
    d = A.decode_window_attention(q[:, -1:], kr, vr, torch.full((b,), 63),
                                  win)
    f = A.full_attention(q, k, v, causal=True, window=win)[:, -1:]
    assert float(torch.max(torch.abs(d - f))) < 2e-5


# ------------------------------------------------------------------- MoE

def _moe_cfgs(e=8, k=2, cap=4.0, shared=False):
    kw = dict(name="t", family="moe", n_layers=2, d_model=32, n_heads=4,
              n_kv=2, d_ff=64, vocab=128)
    ref = RefModelConfig(**kw, moe=RefMoEConfig(
        n_experts=e, top_k=k, d_ff_expert=64, capacity_factor=cap,
        shared_expert=shared))
    port = ModelConfig(**kw, moe=MoEConfig(
        n_experts=e, top_k=k, d_ff_expert=64, capacity_factor=cap,
        shared_expert=shared))
    return ref, port


def _moe_inputs(rcfg, seed, shape, scale=1.0):
    rp = ref_init_params(rmoe.moe_spec(rcfg), jax.random.PRNGKey(seed))
    x = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    return rp, tree_torch(rp), x


def _ref_routing(rp, x, rcfg):
    xt = j(x.reshape(-1, x.shape[-1]))
    logits = jnp.einsum("td,de->te", xt, rp["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_e = jax.lax.top_k(probs, rcfg.moe.top_k)
    return np.asarray(probs), np.asarray(top_e)


@pytest.mark.parametrize("e,k,cap,shared", [(4, 1, 4.0, False),
                                            (8, 2, 4.0, False),
                                            (16, 4, 4.0, False),
                                            (4, 1, 4.0, True),
                                            (4, 2, 0.25, False)])
def test_moe_block_twin(e, k, cap, shared):
    """Routing first, exactly; then y and aux_loss within tolerance.  The
    last case drops choices past a tiny capacity: which ones, the stable
    sort by expert decides.  The router's init (std 0.006) leaves the
    probabilities within 1e-5 of each other at unit inputs, so the inputs
    are scaled by 30 to spread them past the margin the check needs."""
    rcfg, cfg = _moe_cfgs(e, k, cap, shared)
    rp, pp, x = _moe_inputs(rcfg, 20 + e + k, (2, 16, 32), scale=30.0)
    probs, ref_top_e = _ref_routing(rp, x, rcfg)
    # the k-th and (k+1)-th probabilities are apart by more than the
    # tolerance, so that a tie would show as a tie, not a wrong expert
    srt = np.sort(probs, axis=-1)[:, ::-1]
    if k < e:
        assert np.all(srt[:, k - 1] - srt[:, k] > F32_TOL * srt[:, 0])
    _, _, _, top_e = moe.route(pp, t(x).reshape(-1, 32), cfg)
    assert np.array_equal(top_e.numpy(), ref_top_e)

    ry, raux = jax.jit(lambda p, x: rmoe.moe_block(p, x, rcfg))(rp, j(x))
    py, paux = moe.moe_block(pp, t(x), cfg)
    assert_close(py, ry, what="y")
    assert_close(paux, raux, what="aux")
    assert_close(moe.moe_ref(pp, t(x), cfg), rmoe.moe_ref(rp, j(x), rcfg),
                 what="moe_ref")


def test_moe_top_k_ties_take_lower_index():
    """Exact ties in the router (zero router weights: uniform probs) pick
    the lowest expert ids, as ``jax.lax.top_k`` does."""
    rcfg, cfg = _moe_cfgs(8, 2)
    rp, pp, x = _moe_inputs(rcfg, 5, (1, 4, 32))
    pp["router"] = torch.zeros_like(pp["router"])
    _, _, _, top_e = moe.route(pp, t(x).reshape(-1, 32), cfg)
    assert top_e.tolist() == [[0, 1]] * 4


@pytest.mark.parametrize("e,k", [(4, 1), (8, 2), (16, 4)])
def test_moe_matches_dense_reference(e, k):
    _, cfg = _moe_cfgs(e, k)
    p = init_params(moe.moe_spec(cfg), seed=0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, 32)).astype(np.float32))
    y, aux = moe.moe_block(p, x, cfg)
    yr = moe.moe_ref(p, x, cfg)
    assert float(torch.max(torch.abs(y - yr))) < 1e-4
    assert float(aux) > 0


def test_moe_shared_expert():
    _, cfg = _moe_cfgs(4, 1, shared=True)
    p = init_params(moe.moe_spec(cfg), seed=2)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 8, 32)).astype(np.float32))
    y, _ = moe.moe_block(p, x, cfg)
    yr = moe.moe_ref(p, x, cfg)
    assert float(torch.max(torch.abs(y - yr))) < 1e-4


def test_moe_capacity_drops_degrade_gracefully():
    _, cfg = _moe_cfgs(4, 2, cap=0.25)
    p = init_params(moe.moe_spec(cfg), seed=4)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 32, 32)).astype(np.float32))
    y, _ = moe.moe_block(p, x, cfg)
    assert bool(torch.all(torch.isfinite(y)))


@given(st.integers(0, 10_000))
@settings(max_examples=10, deadline=None)
def test_property_moe_router_load_balance_loss_bounds(seed):
    """Aux loss >= 1 with equality iff perfectly balanced (Switch lemma)."""
    _, cfg = _moe_cfgs(4, 1, cap=8.0)
    p = init_params(moe.moe_spec(cfg), seed=seed % 97)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 32, 32)).astype(np.float32))
    _, aux = moe.moe_block(p, x, cfg)
    assert float(aux) > 0.9
