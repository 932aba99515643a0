"""LM losses and public model API (the port of ``repro.models.lm``)."""
from __future__ import annotations

import torch

from repro_torch.core.backend import resolve_device

from . import layers, transformer
from .params import ParamTree, abstract_params, count_params, init_tree


def causal_lm_loss(logits, targets, cfg, mask=None, z_loss: float = 1e-4):
    """Next-token cross entropy with padded-vocab masking + z-loss.

    logits (B, S, Vpad); targets (B, S) — already shifted by the data
    pipeline (targets[t] is the token after inputs[t]).
    """
    v = cfg.vocab
    if layers.split_dim(logits, -1):
        lse, gold = _lse_gold_on_shards(logits, targets, v)
    else:
        logits = logits.float()
        # mask padded vocab entries out of the softmax
        vpad = logits.shape[-1]
        if vpad > v:
            logits = logits.clone()
            logits[..., v:] = -1e30
        lse = torch.logsumexp(logits, dim=-1)
        gold = layers.settled(
            torch.gather(logits, -1, targets.long()[..., None]))[..., 0]
    nll = lse - gold
    zl = z_loss * torch.square(lse)
    per_tok = nll + zl
    if mask is None:
        mask = torch.ones_like(targets, dtype=torch.float32)
    mask = mask.float()
    denom = torch.clamp(torch.sum(mask), min=1.0)
    total = torch.sum(per_tok * mask) / denom
    return total, {"nll": torch.sum(nll * mask) / denom}


def _lse_gold_on_shards(logits, targets, v):
    """(logsumexp, gold logit) of vocabulary-sharded DTensor ``logits``,
    each rank on its own columns (vocabulary-parallel cross entropy):
    gathering the logits would hold all of them on every rank.  A rank
    masks its padded columns, takes its max (all-reduced), its sum of
    exponentials and the gold logits its columns hold (each all-reduced
    as a pending sum)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    logits = layers.placed(logits, model=-1, dp=0)
    targets = layers.placed(targets, dp=0)
    mesh = logits.device_mesh
    ll, tl = layers.shards(logits, targets)
    _, offset = compute_local_shape_and_global_offset(
        logits.shape, mesh, logits.placements)
    lo, n = offset[-1], ll.shape[-1]
    col = torch.arange(lo, lo + n, device=ll.device)
    ll = torch.where(col < v, ll.float(), -1e30)

    def whole(x, op):
        """A rank's part ``x`` (B, S) reduced with ``op`` over the ranks
        that split the vocabulary."""
        pl = [Shard(0) if isinstance(q, Shard) and q.dim == 0 else
              Partial(op) if isinstance(q, Shard) else Replicate()
              for q in logits.placements]
        x = DTensor.from_local(x, mesh, pl, run_check=False)
        return x.redistribute(mesh, [Shard(0) if isinstance(q, Shard)
                                     else Replicate() for q in pl])

    m = whole(torch.amax(ll.detach(), dim=-1), "max")
    lse = torch.log(whole(torch.sum(torch.exp(
        ll - layers.shards(m)[0][..., None]), dim=-1), "sum")) + m
    t = tl.long()
    hit = (t >= lo) & (t < lo + n)
    gold = torch.gather(ll, -1, torch.where(hit, t - lo, 0)[..., None])
    gold = whole(gold[..., 0] * hit, "sum")
    return lse, gold


class Model(ParamTree):
    """A config's parameters as modules (``ParamTree`` of
    ``transformer.lm_spec``: ``embed.table``, ``layers[r].layer0.attn.
    attn.wq``, ``final_norm.scale``, ...) and its forward.

    ``device`` resolves through ``backend.resolve_device`` (``cuda`` unless
    the caller names another); ``device="meta"`` allocates nothing.  The
    parameters are drawn from a ``torch.Generator`` seeded with ``seed`` on
    that device, by the reference's init rule (``params.init_std``)."""

    def __init__(self, cfg, device=None, seed: int = 0):
        dev = resolve_device(device)
        spec = transformer.lm_spec(cfg)
        super().__init__(spec, getattr(torch, cfg.param_dtype), dev)
        self.cfg = cfg
        self.spec = spec
        self.device = dev
        if dev.type != "meta":
            self.init(seed)

    def init(self, seed: int = 0):
        """Draw every parameter anew from ``seed``."""
        init_tree(self, seed)
        return self

    def abstract(self, dtype=None):
        return abstract_params(self.spec,
                               dtype or getattr(torch, self.cfg.param_dtype))

    def n_params(self) -> int:
        return count_params(self.spec)

    def copy_to(self, device) -> "Model":
        """A new Model holding these weights on ``device``."""
        other = Model(self.cfg, device="meta")
        other.to_empty(device=device)
        other.load_state_dict(self.state_dict())
        other.device = torch.device(device)
        return other

    def forward(self, tokens, **kw):
        """``transformer.forward``: (logits, new_cache, aux_loss)."""
        return transformer.forward(self, self.cfg, tokens, **kw)

    def init_cache(self, batch: int, cache_len: int):
        return transformer.init_cache(self.cfg, batch, cache_len, self.device)
