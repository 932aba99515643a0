"""The port's model zoo against the reference's (ROADMAP A14a): the forward
of every ``ARCH_IDS`` architecture under ``reduced`` (the audio and vision
front ends included) with logits and ``aux``, ``causal_lm_loss``, the
weight carry-across both ways, and the seeded init's rule; and the forward
part of ``tests/test_models_smoke.py`` on the port alone.

Tolerances (``lm_twins``): float32 max |port - ref| <= 1e-4 * max |ref|;
bfloat16 (llama4-maverick, bf16 in both dtypes) <= 5e-2 * max |ref| at
every token whose expert is the same in both packages.  The reduced
config's router logits are bfloat16, so two experts can tie to the last
bit, and a last-bit difference in the router's input then sends a token
to another expert (the reference's own jitted and op-by-op forwards
differ that way: ``tests/lm_conditioning.py``).  So the twin first holds
the port's routing of its own MoE input to the reference's routing of
that same input, exactly; then it exempts only the tokens whose expert
the reference itself moves between the two packages' inputs, at most
MAX_MOVED of them.  The MoE block is the last sub-block of the reduced
config, so such a token moves no other token's logits.
Parameter trees compare bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.models import Model as RefModel
from repro.models import causal_lm_loss as ref_loss
from repro.models import moe as ref_moe
from repro.models import transformer as ref_transformer
from repro_torch.configs import get_config, reduced
from repro_torch.models import Model, causal_lm_loss
from repro_torch.models import moe as port_moe
from repro_torch.models.params import from_reference, to_reference_tree

from lm_twins import one_torch_thread  # noqa: F401  (autouse)
from lm_twins import (BF16_TOL, F32_TOL, assert_close, front, j, model_pair,
                      t, to_np, tree_np)

BATCH, SEQ = 2, 32

FORWARD_TOL = {"llama4-maverick-400b-a17b": BF16_TOL}


def _ref_route(p, x, cfg):
    """The reference's routing of x (B, S, d): top-k experts per token
    (``moe_block``'s einsum, softmax and ``lax.top_k``)."""
    xt = x.reshape(-1, x.shape[-1])
    logits = jnp.einsum("td,de->te", xt, p["router"]).astype(jnp.float32)
    return jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.moe.top_k)[1]


def _record_moe_inputs(monkeypatch):
    """Record each package's MoE block inputs, and the reference's routing
    of its input inside its jitted forward (through debug callbacks)."""
    rec = {"ref": [], "ref_top": [], "port": []}
    ref_block, port_block = ref_moe.moe_block, port_moe.moe_block

    def ref_wrap(p, x, cfg):
        jax.debug.callback(lambda v: rec["ref"].append(np.asarray(v)), x)
        jax.debug.callback(lambda v: rec["ref_top"].append(np.asarray(v)),
                           _ref_route(p, x, cfg))
        return ref_block(p, x, cfg)

    def port_wrap(p, x, cfg):
        rec["port"].append(x)
        return port_block(p, x, cfg)

    monkeypatch.setattr(ref_moe, "moe_block", ref_wrap)
    monkeypatch.setattr(port_moe, "moe_block", port_wrap)
    return rec


def _bf16(x):
    return j(to_np(x)).astype(jnp.bfloat16)


# tokens of the forward twin's BATCH * SEQ whose expert may move with the
# last bits of the MoE input (1 of 64 in the test's draw)
MAX_MOVED = 2


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_twin(arch, monkeypatch):
    rec = _record_moe_inputs(monkeypatch)
    rcfg, rm, rp, cfg, pm = model_pair(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    kw = front(cfg, BATCH, rng)
    rl, _, raux = jax.jit(rm.apply)(rp, j(toks),
                                    **{k: j(v) for k, v in kw.items()})
    rl = jax.block_until_ready(rl)
    with torch.no_grad():
        pl, _, paux = pm(t(toks), **{k: t(v) for k, v in kw.items()})
    assert pl.shape == (BATCH, SEQ, cfg.padded_vocab)
    assert pl.dtype == getattr(torch, cfg.dtype)
    tol = FORWARD_TOL.get(arch, F32_TOL)
    if cfg.dtype != "bfloat16":
        assert_close(pl, rl, tol, what=f"{arch} logits")
        assert_close(paux, raux, tol, what=f"{arch} aux")
        return
    # bfloat16: one MoE block, the last sub-block (see the docstring)
    assert cfg.n_reps == 1 and cfg.block_pattern[-1][-1] == "moe"
    assert len(rec["ref"]) == len(rec["ref_top"]) == len(rec["port"]) == 1
    moe_p = pm.layers[0]["layer1"]["moe"]["moe"]
    x_port = rec["port"][0]
    _, _, _, port_top = port_moe.route(moe_p, x_port.reshape(-1, cfg.d_model),
                                       cfg)
    ref_on_port = np.asarray(_ref_route({"router": _bf16(moe_p["router"])},
                                        _bf16(x_port), rcfg))
    assert np.array_equal(port_top.numpy(), ref_on_port)
    moved = np.any(rec["ref_top"][0] != ref_on_port, axis=-1)
    assert moved.sum() <= MAX_MOVED, np.flatnonzero(moved)
    keep = ~moved.reshape(BATCH, SEQ)
    scale = float(np.max(np.abs(to_np(rl))))
    err = np.abs(to_np(pl) - to_np(rl))[keep]
    assert float(err.max()) <= tol * scale, (float(err.max()), scale)
    if not moved.any():
        assert_close(paux, raux, tol, what=f"{arch} aux")


def test_causal_lm_loss_twin():
    from repro.configs import get_config as ref_get, reduced as ref_reduced
    rcfg = ref_reduced(ref_get("qwen3-0.6b"))
    cfg = reduced(get_config("qwen3-0.6b"))
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((2, 8, cfg.padded_vocab)) * 3
              ).astype(np.float32)
    targets = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    mask = (rng.random((2, 8)) > 0.3).astype(np.float32)
    for m in (None, mask):
        rl, rx = ref_loss(j(logits), j(targets), rcfg,
                          mask=None if m is None else j(m))
        pl, px = causal_lm_loss(t(logits), t(targets), cfg,
                                mask=None if m is None else t(m))
        assert_close(pl, rl, what="loss")
        assert_close(px["nll"], rx["nll"], what="nll")
    # the padded vocab entries take no probability
    bumped = logits.copy()
    bumped[..., cfg.vocab:] = 1e4
    assert_close(causal_lm_loss(t(bumped), t(targets), cfg)[0],
                 ref_loss(j(logits), j(targets), rcfg)[0], what="pad")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_carry_across_round_trip(arch):
    """Reference tree -> port -> reference tree, bit for bit; and a port
    init -> tree -> another port model, bit for bit."""
    rcfg, rm, rp, cfg, pm = model_pair(arch)
    back = to_reference_tree(pm)
    flat_ref = jax.tree_util.tree_flatten_with_path(tree_np(rp))[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_ref) == len(flat_back)
    for path, arr in flat_ref:
        assert np.array_equal(to_np(arr), flat_back[path]), path
    fresh = Model(cfg, device="cpu", seed=3)
    copy = Model(cfg, device="cpu", seed=4)
    from_reference(copy, to_reference_tree(fresh))
    for (n1, p1), (n2, p2) in zip(fresh.named_parameters(),
                                  copy.named_parameters()):
        assert n1 == n2 and torch.equal(p1, p2), n1


def test_carry_across_rejects_wrong_shapes():
    _, _, rp, cfg, pm = model_pair("qwen3-0.6b")
    tree = tree_np(rp)
    tree["final_norm"]["scale"] = np.ones(3, np.float32)
    with pytest.raises(ValueError):
        from_reference(pm, tree)
    del tree["final_norm"]
    with pytest.raises((KeyError, ValueError)):
        from_reference(pm, tree)


def _rule_std(p):
    """The reference's init rule on a leaf of its stacked spec."""
    if p.init == "embed":
        return 0.02 * p.scale
    if p.init == "small":
        return 0.006 * p.scale
    fan_in = p.shape[0] if len(p.shape) > 1 else max(p.shape[0], 1)
    return p.scale / np.sqrt(fan_in)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_follows_the_reference_rule(arch):
    """Per-leaf shapes equal the reference init's exactly, zeros and ones
    leaves are exact, and every normal leaf's sample std is within 10% of
    the rule's (fan-in = n_reps on stacked per-layer weights)."""
    from repro.configs import get_config as ref_get, reduced as ref_reduced
    rcfg = ref_reduced(ref_get(arch))
    spec = ref_transformer.lm_spec(rcfg)
    ref_tree = jax.eval_shape(
        lambda: RefModel(rcfg).init(jax.random.PRNGKey(0)))
    port = Model(reduced(get_config(arch)), device="cpu", seed=0)
    tree = to_reference_tree(port)
    leaves = jax.tree_util.tree_flatten_with_path(
        spec, is_leaf=lambda x: hasattr(x, "init"))[0]
    assert len(leaves) == len(jax.tree_util.tree_leaves(tree))
    for path, p in leaves:
        node, ref_node = tree, ref_tree
        for k in path:
            node, ref_node = node[k.key], ref_node[k.key]
        assert node.shape == tuple(ref_node.shape) == p.shape, path
        if p.init == "zeros":
            assert not node.any(), path
        elif p.init == "ones":
            assert np.all(node == 1), path
        else:
            want = _rule_std(p)
            assert abs(float(node.std()) / want - 1) < 0.1, \
                (path, float(node.std()), want)
    if arch == "qwen3-0.6b":
        full = get_config(arch)
        assert np.isclose(_rule_std(ref_transformer.lm_spec(
            ref_get(arch))["layers"]["layer0"]["mlp"]["mlp"]["wo"]),
            1 / np.sqrt(full.n_reps))


def test_init_is_seeded():
    cfg = reduced(get_config("qwen3-0.6b"))
    a = Model(cfg, device="cpu", seed=7)
    b = Model(cfg, device="cpu", seed=7)
    c = Model(cfg, device="cpu", seed=8)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert not torch.equal(a.embed.table, c.embed.table)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(reduced(get_config("qwen3-0.6b")))


# ---------------------------------- the reference's smoke test, on the port

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_smoke(arch):
    cfg = reduced(get_config(arch))
    model = Model(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    toks = t(rng.integers(0, cfg.vocab, (BATCH, SEQ)))
    kw = {}
    if cfg.frontend == "audio":
        kw["enc_embeds"] = torch.ones(BATCH, cfg.encoder_len, cfg.d_model) \
            * 0.01
    if cfg.frontend == "vision":
        kw["prefix_embeds"] = torch.ones(BATCH, cfg.frontend_len,
                                         cfg.d_model) * 0.01
    with torch.no_grad():
        logits, _, aux = model(toks, **kw)
    assert logits.shape == (BATCH, SEQ, cfg.padded_vocab)
    assert bool(torch.all(torch.isfinite(logits))), arch
    assert bool(torch.isfinite(aux))
