"""Shared plumbing of the LM twins (``tests/test_torch_attention_moe.py``,
``test_torch_ssm.py``, ``test_torch_models*.py``, ``test_torch_serve.py``).

A twin gives the same inputs, made from a seed with numpy, to the reference
(``repro``, JAX jitted on the CPU, as its own tests run it) and to the port
(``repro_torch`` on ``device="cpu"``), with the reference's initialised
parameters carried across (``params.from_reference``), and compares:

  * float32 outputs: max |port - reference| <= F32_TOL * max |reference|;
  * bfloat16 outputs: <= BF16_TOL * max |reference|;
  * integer outputs, shapes, counts, specs, routing and greedy tokens:
    exactly.

Float outputs cannot be bit for bit across XLA and PyTorch (the matmuls
sum in another order); 1e-4 of the output's range is some 1000 float32
ulps of it, far below what a wrong mask, rotation or gate moves.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

F32_TOL = 1e-4
BF16_TOL = 5e-2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Test workers run side by side; one torch thread each keeps them from
    oversubscribing the CPU (the results do not depend on it).  Every twin
    file imports it, which makes it autouse there."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tol_for(dtype: str) -> float:
    return BF16_TOL if dtype == "bfloat16" else F32_TOL


def to_np(x):
    """A JAX array or a torch tensor as a float32/int numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def tree_np(tree):
    """A JAX parameter tree as nested dicts of numpy arrays."""
    return jax.tree.map(np.asarray, tree)


def tree_torch(tree):
    """A JAX parameter tree (unstacked block spec) as torch tensors."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def t(x):
    """numpy -> torch (a copy)."""
    return torch.from_numpy(np.array(x))


def j(x):
    return jnp.asarray(x)


def assert_close(port, ref, tol=F32_TOL, what=""):
    """max |port - ref| <= tol * max |ref| (exact when ref is all zero)."""
    p, r = to_np(port), to_np(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    assert np.all(np.isfinite(p)), what
    scale = float(np.max(np.abs(r))) if r.size else 0.0
    err = float(np.max(np.abs(p.astype(np.float64) - r))) if r.size else 0.0
    assert err <= tol * scale, \
        f"{what}: max err {err:.3e} > {tol:g} * max|ref| {scale:.3e}"
    return err / scale if scale else 0.0


def assert_tree_close(port, ref, tol=F32_TOL, what=""):
    """Leaf by leaf over nested dicts of the same keys."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), (what, sorted(port), sorted(ref))
        for k in ref:
            assert_tree_close(port[k], ref[k], tol, f"{what}/{k}")
        return
    assert_close(port, ref, tol, what)


def top2_margin(logits) -> np.ndarray:
    """Per row: the largest logit minus the second largest."""
    x = np.sort(to_np(logits), axis=-1)
    return x[..., -1] - x[..., -2]


def assert_clear_argmax(logits, tol=F32_TOL, what=""):
    """Every row's top-two margin exceeds ``tol * max |logits|``, so that
    its argmax cannot flip within the twins' tolerance."""
    x = to_np(logits)
    m = top2_margin(x)
    bound = tol * float(np.max(np.abs(x)))
    assert np.all(m > bound), \
        f"{what}: near-tie, top-two margin {m.min():.3e} <= {bound:.3e}"


def stack_cache(cache):
    """The reference's stacked (n_reps, ...) cache tree of a port cache
    (a list of one unit dict per repetition)."""
    if isinstance(cache[0], dict):
        return {k: stack_cache([n[k] for n in cache]) for k in cache[0]}
    return torch.stack(cache)


def load(model, tree):
    """``model`` with the reference tree ``tree`` carried across."""
    from repro_torch.models.params import from_reference
    from_reference(model, tree)
    return model


def front(cfg, batch, rng):
    """Seeded frontend inputs (audio frames / vision patches), numpy."""
    out = {}
    if cfg.frontend == "audio":
        out["enc_embeds"] = (rng.standard_normal(
            (batch, cfg.encoder_len, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.frontend == "vision":
        out["prefix_embeds"] = (rng.standard_normal(
            (batch, cfg.frontend_len, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def model_pair(arch, reduce=True, seed=0):
    """(ref cfg, ref Model, ref params, port cfg, port Model on the CPU)
    with the reference's init carried across."""
    from repro.configs import get_config as ref_get, reduced as ref_reduced
    from repro.models import Model as RefModel
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Model

    rcfg, cfg = ref_get(arch), get_config(arch)
    if reduce:
        rcfg, cfg = ref_reduced(rcfg), reduced(cfg)
    rm = RefModel(rcfg)
    rp = rm.init(jax.random.PRNGKey(seed))
    pm = load(Model(cfg, device="cpu"), tree_np(rp))
    return rcfg, rm, rp, cfg, pm


def flat_grads(model, tree):
    """The reference's stacked gradient tree ``tree`` (numpy) as the port's
    gradient list, in ``params.flat_params(model)`` order."""
    from repro_torch.models.params import stacked_leaves
    out = []
    for path, _, ts in stacked_leaves(model):
        arr = tree
        for seg in path:
            arr = arr[seg]
        rows = [arr[r] for r in range(len(ts))] if "layers" in path \
            else [arr]
        out.extend(t(x) for x in rows)
    return out


def stacked_grads(model, grads):
    """The port's gradient list as the reference's stacked tree (numpy)."""
    from repro_torch.models.params import stacked_leaves
    out: dict = {}
    i = 0
    for path, _, ts in stacked_leaves(model):
        gs = [to_np(g) for g in grads[i:i + len(ts)]]
        i += len(ts)
        node = out
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = np.stack(gs) if "layers" in path else gs[0]
    return out
