"""Attention: GQA + qk-norm + RoPE + sliding window + cross + KV-cache decode
(the port of ``repro.models.attention``).

Training / prefill attention keeps the reference's **doubly-chunked online
softmax** schedule: a loop over query chunks and, inside it, over key/value
chunks with float32 accumulators, every block computed (all-mask blocks
too).  Masked scores are ``NEG = -1e30``, not ``-inf``: a fully masked kv
block then gives ``exp(s - m) = 1`` on its masked entries, which a later
block wipes through ``corr = exp(m - m_new)``, where ``-inf`` would give NaN.

GQA is computed with grouped einsums (no materialised head repetition):
q is viewed as (B, S, K, G, hd) with H = K*G.

On a mesh (DTensors), training and prefill attention run on each rank's
shards (``_on_shards``): q, k and v are laid out with the batch over the
data-parallel axes and the heads over the model axis where K divides
into it (``_grouped``), and the blocks are computed locally, with no
collective (the reference's compiler partitions them the same way).
Decode reads a cache whose sequence is sharded over the model axis, so
it runs on DTensors with q's heads replicated there (``layers.placed``).

Cache writes are out of place, like the reference's: each returns new
tensors and leaves its inputs as they were.  A write at ``pos >=
cache_len`` lands on the last slot, as ``lax.dynamic_update_slice``
clamps its start so that the update fits.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from .params import Param
from . import layers

NEG = -1e30


def attention_spec(cfg, cross: bool = False) -> dict:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    if cross:
        k = h                     # whisper cross-attention is MHA
    spec = {
        "wq": Param((d, h, hd), ("embed", "heads", None)),
        "wk": Param((d, k, hd), ("embed", "kv", None)),
        "wv": Param((d, k, hd), ("embed", "kv", None)),
        "wo": Param((h, hd, d), ("heads", None, "embed")),
    }
    if cfg.qk_norm and not cross:
        spec["q_norm"] = layers.rmsnorm_spec(hd)
        spec["k_norm"] = layers.rmsnorm_spec(hd)
    return spec


def project_qkv(p, cfg, xq, xkv, positions_q, positions_kv, rope: bool = True):
    """Returns q (B,Sq,H,hd), k/v (B,Skv,K,hd), rope+qk-norm applied."""
    q = torch.einsum("bsd,dhx->bshx", xq, p["wq"])
    k = torch.einsum("bsd,dkx->bskx", xkv, p["wk"])
    v = torch.einsum("bsd,dkx->bskx", xkv, p["wv"])
    if "q_norm" in p:
        q = layers.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = layers.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if rope:
        cos_q, sin_q = layers.rope_angles(positions_q, cfg.hd, cfg.rope_theta)
        cos_k, sin_k = layers.rope_angles(positions_kv, cfg.hd, cfg.rope_theta)
        q = layers.apply_rope(q, cos_q, sin_q)
        k = layers.apply_rope(k, cos_k, sin_k)
    return q, k, v


def output_proj(p, ctx):
    """ctx (B, S, H, hd) -> (B, S, d)."""
    return torch.einsum("bshx,hxd->bsd", ctx, p["wo"])


def _mask(qpos, kpos, causal: bool, window: Optional[int]):
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    return mask


def _grouped(x, groups: int):
    """``x`` (B, ..., N, hd) in a layout that views as (B, ..., groups,
    N // groups, hd): on a mesh the batch over the DP axes and the model
    axis on the head dim where ``groups`` divides into it, else replicated
    (a kv-head count the axis does not divide leaves k and v replicated,
    ``rules.spec_for``'s fallback, so q's heads are gathered: XLA
    reshards there on its own)."""
    return layers.placed(x, model=-2, dp=0, groups=groups)


def _on_shards(attend, q, k, v, **kw):
    """``attend(q, k, v, **kw)`` on each rank's shards, laid out by
    ``_grouped``: attention is independent per batch row and per kv-head
    group, so a rank's blocks need no other rank's."""
    kh = k.shape[2]
    q, k, v = (_grouped(x, kh) for x in (q, k, v))
    return layers.sharded_like(attend(*layers.shards(q, k, v), **kw), q)


# ----------------------------------------------------- chunked online softmax

def chunked_attention(q, k, v, *, causal: bool, chunk: int,
                      window: Optional[int] = None,
                      q_offset=0, k_offset=0):
    """q (B,Sq,H,hd), k/v (B,Skv,K,hd) -> (B,Sq,H,hd).

    Double-chunked flash schedule; all-mask blocks still execute, as in the
    reference.
    """
    if isinstance(q, DTensor):
        return _on_shards(chunked_attention, q, k, v, causal=causal,
                          chunk=chunk, window=window, q_offset=q_offset,
                          k_offset=k_offset)
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    cq = min(chunk, sq)
    ck = min(chunk, skv)
    assert sq % cq == 0 and skv % ck == 0, (sq, cq, skv, ck)
    nq, nk = sq // cq, skv // ck
    scale = hd ** -0.5
    dev = q.device

    qc = q.reshape(b, nq, cq, kh, g, hd).float() * scale
    kc = k.reshape(b, nk, ck, kh, hd)
    vc = v.reshape(b, nk, ck, kh, hd)
    ar_q = torch.arange(cq, device=dev)
    ar_k = torch.arange(ck, device=dev)

    blocks = []
    for qi in range(nq):
        qb = qc[:, qi]                               # (B,cq,K,G,hd)
        qpos = q_offset + qi * cq + ar_q
        m = torch.full((b, cq, kh, g), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((b, cq, kh, g), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, cq, kh, g, hd), dtype=torch.float32, device=dev)
        for kj in range(nk):
            kpos = k_offset + kj * ck + ar_k
            s = torch.einsum("bqkgx,bckx->bqkgc", qb, kc[:, kj].float())
            mask = _mask(qpos, kpos, causal, window)
            s = torch.where(mask[None, :, None, None, :], s,
                            torch.tensor(NEG, dtype=s.dtype, device=dev))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgc,bckx->bqkgx", p, vc[:, kj].float())
            m = m_new
        blocks.append(acc / torch.clamp(l, min=1e-20)[..., None])
    out = torch.stack(blocks, dim=1).reshape(b, sq, kh, g, hd)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def full_attention(q, k, v, *, causal: bool, window: Optional[int] = None,
                   q_offset=0, k_offset=0):
    """Reference unchunked attention (short sequences / encoder / tests)."""
    if isinstance(q, DTensor):
        return _on_shards(full_attention, q, k, v, causal=causal,
                          window=window, q_offset=q_offset, k_offset=k_offset)
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = hd ** -0.5
    dev = q.device
    qg = q.reshape(b, sq, kh, g, hd).float() * scale
    s = torch.einsum("bqkgx,bckx->bqkgc", qg, k.float())
    qpos = q_offset + torch.arange(sq, device=dev)
    kpos = k_offset + torch.arange(k.shape[1], device=dev)
    mask = _mask(qpos, kpos, causal, window)
    s = torch.where(mask[None, :, None, None, :], s,
                    torch.tensor(NEG, dtype=s.dtype, device=dev))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgc,bckx->bqkgx", p, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


# ------------------------------------------------------------------- decode

def decode_attention(q, k_cache, v_cache, pos, *,
                     window: Optional[int] = None):
    """Single-token decode: q (B,1,H,hd); cache (B,Smax,K,hd); pos (B,).

    Attends to cache positions <= pos (per slot), optional sliding window.
    """
    b, _, h, hd = q.shape
    smax, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    scale = hd ** -0.5
    qg = layers.placed(q, dp=0).reshape(b, kh, g, hd).float() * scale
    s = torch.einsum("bkgx,bckx->bkgc", qg, k_cache.float())
    kpos = torch.arange(smax, device=q.device)
    mask = kpos[None, :] <= pos[:, None]
    if window is not None:
        mask &= (pos[:, None] - kpos[None, :]) < window
    s = torch.where(mask[:, None, None, :], s,
                    torch.tensor(NEG, dtype=s.dtype, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckx->bkgx", p, v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def update_cache(k_cache, v_cache, k_new, v_new, pos):
    """Write k/v_new (B,1,K,hd) at per-slot positions pos (B,); a position
    past the end clamps to the last slot (``dynamic_update_slice``)."""
    smax = k_cache.shape[1]
    idx = torch.clamp(pos.long(), 0, smax - 1)
    if isinstance(k_cache, DTensor):
        # on a mesh the sequence is sharded (``rules.cache_shardings``): a
        # select over it writes each rank's own rows, gathering nothing,
        # and the new cache keeps the old one's layout
        hit = (torch.arange(smax, device=idx.device)[None, :]
               == idx[:, None])[:, :, None, None]
        return tuple(torch.where(
            hit, layers.placed(new, dp=0).to(c.dtype), c).redistribute(
                c.device_mesh, c.placements)
            for c, new in ((k_cache, k_new), (v_cache, v_new)))
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache = k_cache.index_put((rows, idx), k_new[:, 0].to(k_cache.dtype))
    v_cache = v_cache.index_put((rows, idx), v_new[:, 0].to(v_cache.dtype))
    return k_cache, v_cache


def update_window_cache(k_cache, v_cache, k_new, v_new, pos):
    """Ring-buffer write for sliding-window caches: slot = pos % window."""
    win = k_cache.shape[1]
    return update_cache(k_cache, v_cache, k_new, v_new, pos % win)


def decode_window_attention(q, k_cache, v_cache, pos, window: int):
    """Decode against a ring-buffer cache of size ``window``."""
    b, _, h, hd = q.shape
    win, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    scale = hd ** -0.5
    qg = layers.placed(q, dp=0).reshape(b, kh, g, hd).float() * scale
    s = torch.einsum("bkgx,bckx->bkgc", qg, k_cache.float())
    slot = torch.arange(win, device=q.device)
    # slot holds absolute position: p_abs = pos - ((pos - slot) mod win)
    age = (pos[:, None] - slot[None, :]) % win
    p_abs = pos[:, None] - age
    mask = (p_abs >= 0) & (p_abs <= pos[:, None])
    s = torch.where(mask[:, None, None, :], s,
                    torch.tensor(NEG, dtype=s.dtype, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckx->bkgx", p, v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)
