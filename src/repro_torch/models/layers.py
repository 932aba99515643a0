"""Shared layers: norms, embeddings, RoPE, MLPs (the port of
``repro.models.layers``).  Each function takes its parameters as a mapping
(a ``ParamTree`` or a dict of tensors) and tensors on any device."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .params import Param


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
    return p["table"][ids]


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
