"""Shared layers: norms, embeddings, RoPE, MLPs (the port of
``repro.models.layers``).  Each function takes its parameters as a mapping
(a ``ParamTree`` or a dict of tensors) and tensors on any device, or
DTensors on a mesh (``train.step.shard_state``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.sharding import rules as rules_lib

from .params import Param


def settled(x):
    """A DTensor's pending sums (``Partial`` placements, e.g. a lookup in a
    vocabulary-sharded table) all-reduced to replicated; anything else as
    it is."""
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def split_dim(x, dim: int) -> bool:
    """Whether DTensor ``x`` splits dim ``dim`` over a mesh dim of more
    than one rank (False for a plain tensor)."""
    if not isinstance(x, DTensor):
        return False
    d = dim % x.ndim
    return any(isinstance(p, Shard) and p.dim == d and x.device_mesh.size(i)
               > 1 for i, p in enumerate(x.placements))


def placed(x, *, model=None, dp=None, groups=None):
    """On a mesh, ``x`` with the model axis on dim ``model`` and the
    data-parallel axes on dim ``dp``, each where the dim divides into it
    (``rules.batch_sharding``'s fallback), else replicated there; ``None``
    replicates.  ``groups``: the model axis goes on dim ``model`` only if
    it also divides ``groups`` (a dim about to be split into ``groups``
    parts).  Pending sums are reduced on the way.  DTensor places each
    op's output by that op alone, so the model pins its activations where
    a later view must split them.  A plain tensor is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    dp_axes = rules_lib.dp_axes(mesh)
    dpn = 1
    for name in dp_axes:
        dpn *= mesh.size(mesh.mesh_dim_names.index(name))
    pl = []
    for i, name in enumerate(mesh.mesh_dim_names):
        dim, ways = (dp, dpn) if name in dp_axes else (model, mesh.size(i))
        ok = dim is not None and mesh.size(i) > 1 \
            and x.shape[dim] % ways == 0 and (
            name in dp_axes or groups is None or groups % ways == 0)
        pl.append(Shard(dim % x.ndim) if ok else Replicate())
    return x if pl == list(x.placements) else x.redistribute(mesh, pl)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def shards(*xs):
    """Each DTensor of ``xs`` as this rank's shard, anything else as it is:
    the inputs of a computation that each rank runs on its shards.

    Autograd flows back to the DTensors: a shard's gradient is contiguous
    (DTensor views a shard where PyTorch would view the whole tensor, and
    the local backward may leave it strided), and an input replicated on
    a mesh dim over which another input is split gets a pending sum there
    (``Partial``): each rank's gradient is then its part of the whole."""
    split = {i for x in xs if isinstance(x, DTensor)
             for i, p in enumerate(x.placements) if isinstance(p, Shard)}

    def local(x):
        grad = [Partial() if i in split and isinstance(p, Replicate) else p
                for i, p in enumerate(x.placements)]
        return _ContiguousGrad.apply(x.to_local(grad_placements=grad))
    return [local(x) if isinstance(x, DTensor) else x for x in xs]


def sharded_like(t, like, dims=None):
    """This rank's shard ``t`` as a DTensor on ``like``'s mesh with
    ``like``'s placements, a ``Shard`` of ``like``'s dim d becoming one of
    ``t``'s dim ``dims[d]`` (default d); ``t`` itself when ``like`` is a
    plain tensor."""
    if not isinstance(like, DTensor):
        return t
    pl = [Shard(dims[p.dim] if dims else p.dim) if isinstance(p, Shard)
          else p for p in like.placements]
    return DTensor.from_local(t, like.device_mesh, pl, run_check=False)


class _GradInLayout(torch.autograd.Function):
    """Identity whose backward gives the gradient its input's layout
    (pending sums replicated)."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh = x.device_mesh
        ctx.placements = [Replicate() if p.is_partial() else p
                          for p in x.placements]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


def merged(x, shape):
    """``x`` viewed as ``shape``, which merges dims of ``x``.  On a mesh
    the backward, which splits the gradient again, first gives it the
    merged tensor's layout: the gradient arrives in whatever layout the
    later ops chose, which DTensor may not be able to split."""
    x = x.reshape(shape)
    return _GradInLayout.apply(x) if isinstance(x, DTensor) else x


# ------------------------------------------------------------------- norms

def rmsnorm_spec(d: int) -> dict:
    return {"scale": Param((d,), (None,), "ones")}


def rmsnorm(p, x, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def layernorm_spec(d: int) -> dict:
    return {"scale": Param((d,), (None,), "ones"),
            "bias": Param((d,), (None,), "zeros")}


def layernorm(p, x, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(dt)


# -------------------------------------------------------------- embeddings

def embedding_spec(vocab: int, d: int) -> dict:
    return {"table": Param((vocab, d), ("vocab", "embed"), "embed")}


def embed(p, ids):
    table = p["table"]
    if isinstance(table, DTensor):
        return _embed_on_shards(table, ids)
    return table[ids]


def _embed_on_shards(table, ids):
    """``table[ids]`` on a mesh, each rank on its shards: the ids with
    their batch over the DP axes, the table as placed (its vocabulary over
    the model axis where it divides).  A rank looks up the ids its rows
    hold and zeros the rest, and the pending sum over the ranks holding
    other rows is reduced: the rows themselves, exactly.  (DTensor's own
    rules for a sharded lookup fail in the backward, on a table tied to
    the output head.)"""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    ids = placed(ids, dp=0)
    tl, il = shards(table, ids)
    _, offset = compute_local_shape_and_global_offset(
        table.shape, table.device_mesh, table.placements)
    if any(isinstance(q, Shard) and q.dim == 0 for q in table.placements):
        lo, n = offset[0], tl.shape[0]
        hit = (il >= lo) & (il < lo + n)
        rows = tl[torch.where(hit, il - lo, 0)] * hit[..., None].to(tl.dtype)
    else:
        rows = tl[il]
    pl = []
    for q_ids, q_tab in zip(ids.placements, table.placements):
        if isinstance(q_ids, Shard):
            pl.append(q_ids)
        elif isinstance(q_tab, Shard):
            pl.append(Partial() if q_tab.dim == 0 else Shard(rows.ndim - 1))
        else:
            pl.append(Replicate())
    return settled(DTensor.from_local(rows, table.device_mesh, pl,
                                      run_check=False))


def unembed(p, x):
    """Project to (padded) vocab logits."""
    return torch.einsum("...d,vd->...v", x, p["table"])


def output_head_spec(d: int, vocab: int) -> dict:
    return {"proj": Param((d, vocab), ("embed", "vocab"), "normal")}


def output_head(p, x):
    return torch.einsum("...d,dv->...v", x, p["proj"])


def positional_embedding_spec(max_len: int, d: int) -> dict:
    return {"pos": Param((max_len, d), (None, "embed"), "embed")}


def sinusoidal_positions(length: int, d: int, dtype=torch.float32,
                         device="cpu"):
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp(-math.log(10000.0) * 2 * dim / d)
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# -------------------------------------------------------------------- RoPE

def rope_angles(positions, hd: int, theta: float):
    """positions (...,) -> cos/sin (..., hd/2), computed in float32 from
    ``theta ** (-2 i / hd)``."""
    dim = torch.arange(hd // 2, dtype=torch.float32, device=positions.device)
    inv = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                 device=positions.device), -2.0 * dim / hd)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, H, hd); cos/sin (..., S, hd/2) broadcast over heads.
    Rotates the two halves of the head dim (not interleaved pairs)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------- MLP

def swiglu_spec(d: int, f: int) -> dict:
    return {
        "wi_gate": Param((d, f), ("embed", "mlp")),
        "wi_up": Param((d, f), ("embed", "mlp")),
        "wo": Param((f, d), ("mlp", "embed")),
    }


def swiglu(p, x):
    g = torch.einsum("...d,df->...f", x, p["wi_gate"])
    u = torch.einsum("...d,df->...f", x, p["wi_up"])
    return torch.einsum("...f,fd->...d", F.silu(g) * u, p["wo"])


def gelu_mlp_spec(d: int, f: int) -> dict:
    return {
        "wi": Param((d, f), ("embed", "mlp")),
        "bi": Param((f,), ("mlp",), "zeros"),
        "wo": Param((f, d), ("mlp", "embed")),
        "bo": Param((d,), (None,), "zeros"),
    }


def gelu_mlp(p, x):
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(torch.einsum("...d,df->...f", x, p["wi"]) + p["bi"],
               approximate="tanh")
    return torch.einsum("...f,fd->...d", h, p["wo"]) + p["bo"]
