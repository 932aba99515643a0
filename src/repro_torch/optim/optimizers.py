"""Optimizers: AdamW and Adafactor (factored second moments), the port of
``repro.optim.optimizers``.

Adafactor is the memory story for the 400B MoE: O(n+m) second-moment state
for an (n, m) matrix instead of O(n*m), plus bf16 momentum — ~2.x
bytes/param of optimizer state instead of 8 (fp32 AdamW m+v).

The optimizer state has the reference's layout: trees keyed like the
stacked spec (``params.spec``), each leaf a tensor of the *stacked* shape
``(n_reps, ...)`` for a per-layer weight, so a checkpoint writes exactly
the reference's tree.  The parameters are the port's modules, one
``nn.ModuleList`` entry per repetition; ``grads`` is a list in
``params.flat_params`` order.  AdamW is elementwise and updates each
repetition through a view of its row of the stacked state.  Adafactor is
not: a stacked ``(n_reps, d)`` leaf is factored across the repetitions
(``vr`` of shape ``(n_reps,)``, ``vc`` of ``(d,)``) and its update's RMS
clip is one mean over the whole stacked leaf, so it stacks each leaf's
repetitions before it factors and clips.

The updates write the parameters and the state in place and return them,
as the reference returns its new trees.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.models.params import leaves, map_spec, stacked_leaves

F32 = torch.float32


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


def clip_by_global_norm(grads, max_norm):
    """(grads scaled to a global norm of at most ``max_norm``, in float32;
    the norm before scaling)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return torch._foreach_mul([g.float() for g in grads], scale), norm


def warmup_cosine(step, *, peak, warmup, total, floor=0.1):
    step = step.float()
    warm = peak * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = floor * peak + (1 - floor) * peak * 0.5 * (
        1 + torch.cos(torch.pi * frac))
    return torch.where(step < warmup, warm, cos)


def _device(params) -> torch.device:
    return next(params.parameters()).device


def _groups(grads, state_tree, params):
    """Per leaf of the stacked spec: (its parameter tensors, their
    gradients, its state leaf, whether the leaf is stacked)."""
    out, i = [], 0
    for path, _, ts in stacked_leaves(params):
        node = state_tree
        for seg in path:
            node = node[seg]
        out.append((ts, grads[i:i + len(ts)], node, "layers" in path))
        i += len(ts)
    if i != len(grads):
        raise ValueError(f"{len(grads)} gradients for {i} parameters")
    return out


def _apply(ts, new):
    """Write the float32 values ``new`` into the parameters ``ts``."""
    for t, n in zip(ts, new):
        t.copy_(n)


def _unstack(x, ts):
    """A stacked ``(n_reps, ...)`` leaf ``x`` as one tensor per repetition.
    On a mesh ``x`` is first laid out as the repetitions ``ts`` are
    stacked: DTensor may have split the repetition dim itself, which it
    cannot unbind."""
    if isinstance(x, DTensor):
        pl = [Shard(p.dim + 1) if isinstance(p, Shard) else p
              for p in ts[0].placements]
        x = x.redistribute(x.device_mesh, pl)
    return x.unbind(0)


# ------------------------------------------------------------------- AdamW

def adamw_init(params):
    dev = _device(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=dev)
    return {"m": map_spec(zeros, params.spec),
            "v": map_spec(zeros, params.spec),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    c = state["count"] + 1
    cf = c.float()
    bc1 = 1 - b1 ** cf
    bc2 = 1 - b2 ** cf
    m_groups = _groups(grads, state["m"], params)
    v_groups = _groups(grads, state["v"], params)
    with torch.no_grad():
        for (ts, gs, m, stacked), (_, _, v, _) in zip(m_groups, v_groups):
            g = [x.float() for x in gs]
            # each repetition updates its row of the stacked state
            m, v = (list(m.unbind(0)), list(v.unbind(0))) if stacked \
                else ([m], [v])
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
            gg = torch._foreach_mul(g, 1 - b2)
            torch._foreach_mul_(gg, g)
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, gg)
            mh = torch._foreach_div(m, bc1)
            vh = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(vh)
            torch._foreach_add_(vh, eps)
            torch._foreach_div_(mh, vh)
            p32 = [t.float() for t in ts]
            torch._foreach_add_(mh, torch._foreach_mul(p32, weight_decay))
            torch._foreach_mul_(mh, lr)
            _apply(ts, torch._foreach_sub(p32, mh))
    state["count"] = c
    return params, state


# --------------------------------------------------------------- Adafactor

def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor_init(params):
    dev = _device(params)

    def zeros(shape, dtype=F32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def vstate(p):
        s = p.shape
        if _factored(s):
            return (zeros(s[:-1]), zeros(s[:-2] + s[-1:]))
        return (zeros(s), zeros((1,)))             # dummy second slot
    return {"v": map_spec(vstate, params.spec),
            "m": map_spec(lambda p: zeros(p.shape, torch.bfloat16),
                          params.spec),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def adafactor_update(grads, state, params, *, lr, b1=0.9, decay=0.8,
                     eps=1e-30, weight_decay=0.0, clip_threshold=1.0,
                     **_ignored):
    c = state["count"] + 1
    beta2 = 1.0 - c.float() ** (-decay)
    m_groups = _groups(grads, state["m"], params)
    v_groups = _groups(grads, state["v"], params)
    with torch.no_grad():
        for (ts, gs, m, stacked), (_, _, v, _) in zip(m_groups, v_groups):
            # the stacked leaf, as the reference sees it
            stack = torch.stack if stacked else (lambda xs: xs[0])
            g = stack([x.float() for x in gs])
            p = stack([t.float() for t in ts])
            g2 = g * g + eps
            if _factored(p.shape):
                vr = beta2 * v[0] + (1 - beta2) * torch.mean(g2, dim=-1)
                vc = beta2 * v[1] + (1 - beta2) * torch.mean(g2, dim=-2)
                denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                    min=eps)
                pre = (vr / denom)[..., None] * vc[..., None, :]
                update = g * torch.rsqrt(torch.clamp(pre, min=eps))
                nv = (vr, vc)
            else:
                vv = beta2 * v[0] + (1 - beta2) * g2
                update = g * torch.rsqrt(torch.clamp(vv, min=eps))
                nv = (vv, v[1])
            rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-12)
            update = update / torch.clamp(rms / clip_threshold, min=1.0)
            mm = b1 * m.float() + (1 - b1) * update
            step = mm + weight_decay * p
            for old, new in zip(v, nv):
                old.copy_(new)
            m.copy_(mm.to(torch.bfloat16))
            new_p = p - lr * step
            _apply(ts, _unstack(new_p, ts) if stacked else [new_p])
    state["count"] = c
    return params, state


def opt_init(name: str):
    return {"adamw": adamw_init, "adafactor": adafactor_init}[name]


def opt_update(name: str):
    return {"adamw": adamw_update, "adafactor": adafactor_update}[name]


def opt_state_bytes(name: str, spec) -> int:
    """Analytic optimizer-state footprint of a stacked spec tree (for the
    dry-run memory report), on the reference's stacked shapes."""
    total = 0
    for _, p in leaves(spec):
        n = 1
        for s in p.shape:
            n *= s
        if name == "adamw":
            total += 8 * n
        else:
            total += 2 * n                        # bf16 momentum
            if _factored(p.shape):
                rows = n // p.shape[-1]
                total += 4 * (rows + n // rows if len(p.shape) == 2
                              else rows + (n // p.shape[-2]))
            else:
                total += 4 * n
    return total

