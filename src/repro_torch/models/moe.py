"""Mixture-of-Experts with capacity-factor dispatch (the port of
``repro.models.moe``, Switch/GShard style).

Dispatch is sort-based: token choices are sorted by expert id (stably),
ranked within their expert group, and scattered into per-expert capacity
buffers; choices ranked past the capacity are dropped.  Three points keep
the routing equal to the reference's:

  * top-k is a stable descending sort (``jax.lax.top_k`` breaks ties by
    the lower index; ``torch.topk`` promises no order among ties);
  * the sort by expert id is stable, which sets which choices are dropped;
  * the dropped choices' out-of-range slot ``n_experts * cap`` is a spare
    buffer row that is sliced off (``mode="drop"`` in the reference).

On a mesh the dispatch stays global, as the reference's program is: one
capacity for all tokens, so every rank routes all of them (the tokens
gathered), and the routing, dispatch and combine run on each rank's
whole copies (``layers.shards``; DTensor has no rules for their index
writes).  The experts' products run on DTensors, with the experts on the
model axis and the capacity rows on the data-parallel axes, and their
outputs are gathered for the combine.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers
from .params import Param


def moe_spec(cfg) -> dict:
    d, m = cfg.d_model, cfg.moe
    spec = {
        "router": Param((d, m.n_experts), ("embed", None), "small"),
        "wi_gate": Param((m.n_experts, d, m.d_ff_expert),
                         ("expert", "embed", "mlp")),
        "wi_up": Param((m.n_experts, d, m.d_ff_expert),
                       ("expert", "embed", "mlp")),
        "wo": Param((m.n_experts, m.d_ff_expert, d),
                    ("expert", "mlp", "embed")),
    }
    if m.shared_expert:
        spec["shared"] = {
            "wi_gate": Param((d, m.d_ff_expert), ("embed", "mlp")),
            "wi_up": Param((d, m.d_ff_expert), ("embed", "mlp")),
            "wo": Param((m.d_ff_expert, d), ("mlp", "embed")),
        }
    return spec


def _capacity(tokens: int, cfg) -> int:
    m = cfg.moe
    c = int(tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)       # round up to 8


def route(p, xt, cfg):
    """Router of ``xt`` (T, d): (logits f32 (T, E), probs, top_w, top_e)."""
    logits = torch.einsum("td,de->te", xt, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    top_w, top_e = top_w[:, :k], top_e[:, :k]
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    return logits, probs, top_w, top_e


def _shared(sp, xt):
    sg = torch.einsum("td,df->tf", xt, sp["wi_gate"])
    su = torch.einsum("td,df->tf", xt, sp["wi_up"])
    return torch.einsum("tf,fd->td", F.silu(sg) * su, sp["wo"]).float()


def expert_counts(flat_e, n_experts: int):
    """Choices per expert, ``torch.bincount(flat_e, minlength=n_experts)``
    with a shape that does not depend on the data (int64), so that the
    block traces on meta and fake tensors."""
    ones = torch.ones_like(flat_e)
    return flat_e.new_zeros((n_experts,)).scatter_add_(0, flat_e, ones)


def moe_block(p, x, cfg):
    """x (B, S, d) -> (y (B, S, d), aux_loss scalar)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    x_in = x.reshape(t, d)
    # on a mesh every rank routes all tokens, on its whole copies
    xt = layers.placed(x_in)
    xl, router = layers.shards(xt, layers.placed(p["router"]))
    cap = _capacity(t, cfg)
    dev = x.device

    logits, probs, top_w, top_e = route({"router": router}, xl, cfg)

    # ---- load-balance + router-z auxiliary losses (Switch Transformer)
    me = torch.mean(probs, dim=0)                            # (E,)
    ce = torch.mean(
        torch.sum(F.one_hot(top_e, m.n_experts).float(), dim=1), dim=0)
    aux = m.n_experts * torch.sum(me * ce)
    zloss = m.router_z_loss * torch.mean(
        torch.square(torch.logsumexp(logits, dim=-1)))
    aux_loss = layers.sharded_like(aux + zloss, xt)

    # ---- sort-based capacity dispatch
    flat_e = top_e.reshape(-1)                               # (T*k,)
    flat_w = top_w.reshape(-1)
    flat_tok = torch.repeat_interleave(torch.arange(t, device=dev), m.top_k)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    tok_sorted = flat_tok[order]
    w_sorted = flat_w[order]
    counts = expert_counts(flat_e, m.n_experts)
    starts = torch.cumsum(counts, dim=0) - counts
    rank = torch.arange(t * m.top_k, device=dev) - starts[e_sorted]
    keep = rank < cap
    n_slots = m.n_experts * cap
    slot = torch.where(keep, e_sorted * cap + rank,
                       torch.full_like(rank, n_slots))

    # one spare row takes the dropped choices' writes
    buf = xl.new_zeros((n_slots + 1, d))
    buf[slot] = xl[tok_sorted]
    buf = buf[:n_slots].reshape(m.n_experts, cap, d)

    # ---- expert FFN; on a mesh the experts over the model axis and the
    # capacity rows over the data-parallel axes
    buf = layers.placed(layers.sharded_like(buf, xt), model=0, dp=1)
    g = torch.einsum("ecd,edf->ecf", buf, p["wi_gate"])
    u = torch.einsum("ecd,edf->ecf", buf, p["wi_up"])
    eo = torch.einsum("ecf,efd->ecd", F.silu(g) * u, p["wo"])
    eo, = layers.shards(layers.placed(eo))
    eo = eo.reshape(n_slots, d)

    # ---- combine (weighted scatter-add back to token order)
    y = xl.new_zeros((t, d), dtype=torch.float32)
    contrib = eo[torch.clamp(slot, max=n_slots - 1)].float()
    contrib = contrib * (w_sorted * keep)[:, None]
    y.index_add_(0, tok_sorted, contrib)
    y = layers.sharded_like(y, xt)

    if m.shared_expert:
        y = y + _shared(p["shared"], x_in)

    return y.reshape(b, s, d).to(x.dtype), aux_loss


def moe_ref(p, x, cfg):
    """Dense reference (every token through every expert) for tests."""
    m = cfg.moe
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    _, probs, top_w, top_e = route(p, xt, cfg)
    g = torch.einsum("td,edf->etf", xt, p["wi_gate"])
    u = torch.einsum("td,edf->etf", xt, p["wi_up"])
    eo = torch.einsum("etf,efd->etd", F.silu(g) * u, p["wo"])  # (E,T,d)
    w_full = torch.zeros_like(probs)
    rows = torch.arange(xt.shape[0], device=x.device)
    for j in range(m.top_k):
        w_full = w_full.index_put((rows, top_e[:, j]), top_w[:, j],
                                  accumulate=True)
    y = torch.einsum("te,etd->td", w_full, eo.float())
    if m.shared_expert:
        y = y + _shared(p["shared"], xt)
    return y.reshape(b, s, d).to(x.dtype)
