"""Recurrent blocks: Mamba selective SSM, xLSTM mLSTM / sLSTM (the port of
``repro.models.ssm``).

Training paths are *chunk-parallel*, as in the reference:
  * mamba  — a log-depth (Hillis–Steele) inclusive scan over each chunk's
    steps with the reference's combine ``(a1·a2, a2·b1 + b2)`` (torch has
    no ``associative_scan``), the (d_inner, d_state) state carried across
    chunks.  Not the ``exp(cumsum)`` closed form, which over- and
    underflows.  Lengths the chunk does not divide are padded with
    identity steps (``dt = 0``, so decay 1 and input 0);
  * mLSTM  — chunkwise stabilized gated linear attention with running
    log-max stabilizers; masked with ``-inf`` inside a chunk, padded with
    ``log_i = -1e30``;
  * sLSTM  — inherently sequential: a loop over time.

Decode paths are O(1)-state recurrent steps.  ``mamba_ref`` and
``mlstm_ref_inner`` are the sequential oracles.

On a mesh (DTensors) the scans run on each rank's shards, laid out by
``layers.placed``: the batch over the data-parallel axes, the model axis
on d_inner (mamba) or the heads (mLSTM, sLSTM) where it divides them,
else replicated.  The recurrences are per channel or per head, so a
rank's scan needs no other rank's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .params import Param
from . import layers

F32 = torch.float32


# =====================================================================
# Mamba selective SSM
# =====================================================================

def mamba_dims(cfg):
    di = int(cfg.ssm.expand * cfg.d_model)
    dtr = cfg.ssm.dt_rank or max(1, -(-cfg.d_model // 16))
    return di, dtr, cfg.ssm.d_state, cfg.ssm.conv_kernel


def mamba_spec(cfg, d_in: Optional[int] = None) -> dict:
    d = d_in or cfg.d_model
    di, dtr, ds, kc = mamba_dims(cfg)
    return {
        "in_proj": Param((d, 2 * di), ("embed", "mlp")),
        "conv_w": Param((kc, di), (None, "mlp"), "normal", 0.5),
        "conv_b": Param((di,), ("mlp",), "zeros"),
        "x_proj": Param((di, dtr + 2 * ds), ("mlp", None)),
        "dt_proj": Param((dtr, di), (None, "mlp")),
        "dt_bias": Param((di,), ("mlp",), "zeros"),
        "a_log": Param((di, ds), ("mlp", None), "ones"),
        "d_skip": Param((di,), ("mlp",), "ones"),
        "out_proj": Param((di, d), ("mlp", "embed")),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv: x (B,S,di), w (K,di).  state (B,K-1,di) holds
    the trailing inputs of the previous segment (for decode)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, j:j + x.shape[1], :] * w[j] for j in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    return out + b, new_state


def assoc_scan(a, u):
    """Inclusive scan of ``h_t = a_t * h_{t-1} + u_t`` over dim 1 from
    ``h = 0``, in log2(C) doubling steps: returns (cumulative decay,
    cumulative input), the pair ``lax.associative_scan`` gives with the
    combine ``(a1·a2, a2·b1 + b2)``."""
    c = a.shape[1]
    off = 1
    while off < c:
        u = torch.cat([u[:, :off], a[:, off:] * u[:, :-off] + u[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return a, u


def _mamba_scan_fused(dt, x1, bmat, cmat, a_mat, h0, chunk: int):
    """Chunked selective scan with the (B,C,di,ds)-sized decay/input/state
    tensors materialised one chunk at a time.

    dt, x1 (B,S,di) f32; bmat, cmat (B,S,ds) f32; a_mat (di,ds).
    Returns (y (B,S,di), h_end (B,di,ds))."""
    b, s, di = dt.shape
    ds = bmat.shape[-1]
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        zdt = torch.zeros((b, pad, di), dtype=dt.dtype, device=dt.device)
        dt = torch.cat([dt, zdt], dim=1)                 # dt=0 -> decay=1
        x1 = torch.cat([x1, zdt], dim=1)
        zb = torch.zeros((b, pad, ds), dtype=bmat.dtype, device=dt.device)
        bmat = torch.cat([bmat, zb], dim=1)
        cmat = torch.cat([cmat, zb], dim=1)
    nc = (s + pad) // c

    h = h0
    ys = []
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        dt_k, x1_k, b_k, c_k = dt[:, sl], x1[:, sl], bmat[:, sl], cmat[:, sl]
        decay = torch.exp(dt_k[..., None] * a_mat[None, None])
        u = (dt_k * x1_k)[..., None] * b_k[:, :, None, :]
        acum, ucum = assoc_scan(decay, u)
        h_t = acum * h[:, None] + ucum                   # (B,C,di,ds)
        ys.append(torch.sum(h_t * c_k[:, :, None, :], dim=-1))
        h = h_t[:, -1]
    y = torch.cat(ys, dim=1)[:, :s]
    return y, h


def mamba_block(p, x, cfg, state: Optional[Tuple] = None,
                return_state: bool = False):
    """x (B,S,d) -> (B,S,d).  state = (h (B,di,ds), conv (B,K-1,di))."""
    di, dtr, ds, kc = mamba_dims(cfg)
    b, s, _ = x.shape
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    x1, z = torch.chunk(xz, 2, dim=-1)
    conv_state = state[1] if state is not None else None
    x1, new_conv = _causal_conv(x1, p["conv_w"], p["conv_b"], conv_state)
    x1 = F.silu(x1)

    # on a mesh the contraction over the model-sharded d_inner leaves
    # pending sums, reduced here before dt_proj's product reads them
    dbc = layers.settled(torch.einsum("bsi,ie->bse", x1, p["x_proj"]))
    dt_r = dbc[..., :dtr]
    bmat = dbc[..., dtr:dtr + ds].float()
    cmat = dbc[..., dtr + ds:].float()
    dt = F.softplus(
        torch.einsum("bsr,ri->bsi", dt_r, p["dt_proj"]) + p["dt_bias"]
    ).float()
    a_mat = -torch.exp(p["a_log"].float())                   # (di, ds)

    h0 = state[0].float() if state is not None else dt.new_zeros((b, di, ds))
    x1f = x1.float()
    # on a mesh each rank scans its own channels (the recurrence is per
    # channel): d_inner over the model axis, the batch over the DP axes
    dt, x1f = (layers.placed(t, model=2, dp=0) for t in (dt, x1f))
    h0 = layers.placed(h0, model=1, dp=0)
    bmat, cmat = (layers.placed(t, dp=0) for t in (bmat, cmat))
    a_mat = layers.placed(a_mat, model=0)
    y, h_end = _mamba_scan_fused(*layers.shards(dt, x1f, bmat, cmat, a_mat,
                                                h0), cfg.ssm.chunk)
    y, h_end = layers.sharded_like(y, dt), layers.sharded_like(h_end, h0)
    y = y + p["d_skip"].float() * x1f
    y = y.to(x.dtype) * F.silu(z)
    out = torch.einsum("bsi,id->bsd", y, p["out_proj"])
    if return_state:
        return out, (h_end.float(), new_conv)
    return out


def mamba_decode(p, x, cfg, state):
    """Single-token step: x (B,1,d); state (h, conv)."""
    return mamba_block(p, x, cfg, state=state, return_state=True)


def mamba_ref(p, x, cfg):
    """Sequential oracle (python loop over time)."""
    di, dtr, ds, kc = mamba_dims(cfg)
    b, s, _ = x.shape
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    x1, z = torch.chunk(xz, 2, dim=-1)
    x1, _ = _causal_conv(x1, p["conv_w"], p["conv_b"])
    x1 = F.silu(x1)
    dbc = torch.einsum("bsi,ie->bse", x1, p["x_proj"])
    dt_r, bmat, cmat = (dbc[..., :dtr], dbc[..., dtr:dtr + ds].float(),
                        dbc[..., dtr + ds:].float())
    dt = F.softplus(
        torch.einsum("bsr,ri->bsi", dt_r, p["dt_proj"]) + p["dt_bias"]
    ).float()
    a_mat = -torch.exp(p["a_log"].float())
    h = torch.zeros((b, di, ds), dtype=F32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t, :, None] * a_mat[None])
        h = decay * h + (dt[:, t] * x1[:, t].float())[..., None] \
            * bmat[:, t, None, :]
        ys.append(torch.sum(h * cmat[:, t, None, :], dim=-1))
    y = torch.stack(ys, dim=1) + p["d_skip"].float() * x1.float()
    y = y.to(x.dtype) * F.silu(z)
    return torch.einsum("bsi,id->bsd", y, p["out_proj"])


# =====================================================================
# mLSTM (xLSTM matrix memory) — chunkwise gated linear attention
# =====================================================================

def mlstm_dims(cfg):
    di = int(cfg.ssm.expand * cfg.d_model) if cfg.ssm else cfg.d_model
    h = cfg.n_heads
    return di, h, di // h


def mlstm_spec(cfg) -> dict:
    d = cfg.d_model
    di, h, hd = mlstm_dims(cfg)
    return {
        "up": Param((d, 2 * di), ("embed", "mlp")),
        "wq": Param((di, h, hd), ("mlp", "heads", None)),
        "wk": Param((di, h, hd), ("mlp", "heads", None)),
        "wv": Param((di, h, hd), ("mlp", "heads", None)),
        "wi": Param((di, h), ("mlp", "heads"), "small"),
        "wf": Param((di, h), ("mlp", "heads"), "small"),
        "norm": layers.rmsnorm_spec(hd),
        "down": Param((di, d), ("mlp", "embed")),
    }


def _mlstm_chunk(q, k, v, log_f, log_i, carry, hd):
    """One chunk of stabilized gated linear attention.

    q,k,v (B,H,C,hd); log_f/log_i (B,H,C); carry = (Cst (B,H,hd,hd),
    nst (B,H,hd), mst (B,H)).  Returns (h (B,H,C,hd), new carry).
    """
    cst, nst, mst = carry
    c = q.shape[2]
    f_cum = torch.cumsum(log_f, dim=-1)                      # F_t
    # intra-chunk log weights b[t,s] = F_t - F_s + log_i_s  (s <= t)
    bmat = f_cum[..., :, None] - f_cum[..., None, :] + log_i[..., None, :]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    bmat = torch.where(tri, bmat, torch.tensor(-torch.inf, dtype=bmat.dtype,
                                               device=q.device))
    m_intra = torch.amax(bmat, dim=-1)                       # (B,H,C)
    m_cross = mst[..., None] + f_cum                         # (B,H,C)
    m_t = torch.maximum(m_intra, m_cross)

    w_intra = torch.exp(bmat - m_t[..., None])               # (B,H,C,C)
    scale = hd ** -0.5
    scores = torch.einsum("bhtx,bhsx->bhts", q * scale, k) * w_intra
    h_intra = torch.einsum("bhts,bhsx->bhtx", scores, v)
    n_intra = torch.einsum("bhts,bhsx->bhtx", w_intra, k)    # Σ w k_s

    w_cross = torch.exp(m_cross - m_t)                       # (B,H,C)
    h_cross = torch.einsum("bhtx,bhxy->bhty", q * scale, cst) * \
        w_cross[..., None]
    n_cross = nst[:, :, None, :] * w_cross[..., None]

    h_num = h_intra + h_cross
    n_vec = n_intra + n_cross                                # (B,H,C,hd)
    denom = torch.abs(torch.einsum("bhtx,bhtx->bht", q * scale, n_vec))
    denom = torch.maximum(denom, torch.exp(-m_t))
    h = h_num / denom[..., None]

    # ---- carry update to end of chunk
    f_end = f_cum[..., -1]                                   # (B,H)
    m_end_intra = torch.amax(f_end[..., None] - f_cum + log_i, dim=-1)
    m_new = torch.maximum(mst + f_end, m_end_intra)
    w_state = torch.exp(mst + f_end - m_new)
    w_toks = torch.exp(f_end[..., None] - f_cum + log_i - m_new[..., None])
    cst_new = cst * w_state[..., None, None] + torch.einsum(
        "bhsx,bhsy,bhs->bhxy", k, v, w_toks)
    nst_new = nst * w_state[..., None] + torch.einsum(
        "bhsx,bhs->bhx", k, w_toks)
    return h, (cst_new, nst_new, m_new)


def mlstm_inner(q, k, v, log_f, log_i, chunk: int, carry=None):
    """q,k,v (B,S,H,hd) -> h (B,S,H,hd) with chunkwise scan."""
    b, s0, h, hd = q.shape
    c = min(chunk, s0)
    pad = (-s0) % c
    dev = q.device
    if pad:
        # identity steps: f = 1 (log 0), i -> 0 (log -1e30) leave state intact
        zq = torch.zeros((b, pad, h, hd), dtype=q.dtype, device=dev)
        q = torch.cat([q, zq], dim=1)
        k = torch.cat([k, zq.to(k.dtype)], dim=1)
        v = torch.cat([v, zq.to(v.dtype)], dim=1)
        log_f = torch.cat(
            [log_f, torch.zeros((b, pad, h), dtype=log_f.dtype, device=dev)],
            dim=1)
        log_i = torch.cat(
            [log_i, torch.full((b, pad, h), -1e30, dtype=log_i.dtype,
                               device=dev)], dim=1)
    s = s0 + pad
    nc = s // c

    def to_chunks(x):                       # (B,S,H,hd) -> (B,nc,H,C,hd)
        return x.float().reshape(b, nc, c, h, hd).transpose(2, 3)

    def gates_to_chunks(x):                 # (B,S,H) -> (B,nc,H,C)
        return x.float().reshape(b, nc, c, h).transpose(2, 3)

    qc, kc, vc = to_chunks(q), to_chunks(k), to_chunks(v)
    fc, ic = gates_to_chunks(log_f), gates_to_chunks(log_i)
    if carry is None:
        carry = (torch.zeros((b, h, hd, hd), dtype=F32, device=dev),
                 torch.zeros((b, h, hd), dtype=F32, device=dev),
                 torch.full((b, h), -1e30, dtype=F32, device=dev))

    hs = []
    for i in range(nc):
        hk, carry = _mlstm_chunk(qc[:, i], kc[:, i], vc[:, i], fc[:, i],
                                 ic[:, i], carry, hd)
        hs.append(hk)
    hs = torch.stack(hs, dim=1)                              # (B,nc,H,C,hd)
    hs = hs.transpose(2, 3).reshape(b, s, h, hd)[:, :s0]
    return hs, carry


def mlstm_block(p, x, cfg, state=None, return_state: bool = False):
    """x (B,S,d) -> (B,S,d)."""
    di, h, hd = mlstm_dims(cfg)
    xz = torch.einsum("bsd,de->bse", x, p["up"])
    xi, z = torch.chunk(xz, 2, dim=-1)
    q = torch.einsum("bsi,ihx->bshx", xi, p["wq"])
    k = torch.einsum("bsi,ihx->bshx", xi, p["wk"])
    v = torch.einsum("bsi,ihx->bshx", xi, p["wv"])
    log_i = torch.einsum("bsi,ih->bsh", xi, p["wi"]).float()
    f_pre = torch.einsum("bsi,ih->bsh", xi, p["wf"]).float()
    # on a mesh each rank runs its own heads: the batch over the DP axes,
    # the heads over the model axis where they divide into it
    q, k, v, log_i, f_pre = (layers.placed(t, model=2, dp=0)
                             for t in (q, k, v, log_i, f_pre))
    state = [] if state is None else [layers.placed(t, model=1, dp=0)
                                      for t in state]
    ql, kl, vl, fl, il, *state = layers.shards(q, k, v, f_pre, log_i, *state)
    hs, carry = mlstm_inner(ql, kl, vl, F.logsigmoid(fl), il,
                            cfg.ssm.chunk if cfg.ssm else 64,
                            carry=tuple(state) or None)
    hs = layers.sharded_like(hs, q)
    carry = tuple(layers.sharded_like(t, q, {0: 0, 2: 1}) for t in carry)
    hs = layers.rmsnorm(p["norm"], hs.to(x.dtype), cfg.norm_eps)
    y = layers.merged(hs, (x.shape[0], x.shape[1], di)) * F.silu(z)
    out = torch.einsum("bsi,id->bsd", y, p["down"])
    if return_state:
        return out, carry
    return out


def mlstm_ref_inner(q, k, v, log_f, log_i):
    """Sequential oracle of the stabilized mLSTM recurrence."""
    b, s, h, hd = q.shape
    scale = hd ** -0.5
    dev = q.device
    cst = torch.zeros((b, h, hd, hd), dtype=F32, device=dev)
    nst = torch.zeros((b, h, hd), dtype=F32, device=dev)
    mst = torch.full((b, h), -1e30, dtype=F32, device=dev)
    outs = []
    for t in range(s):
        lf, li = log_f[:, t].float(), log_i[:, t].float()
        m_new = torch.maximum(lf + mst, li)
        fw = torch.exp(lf + mst - m_new)
        iw = torch.exp(li - m_new)
        kt, vt, qt = k[:, t].float(), v[:, t].float(), \
            q[:, t].float() * scale
        cst = cst * fw[..., None, None] + iw[..., None, None] * \
            torch.einsum("bhx,bhy->bhxy", kt, vt)
        nst = nst * fw[..., None] + iw[..., None] * kt
        mst = m_new
        num = torch.einsum("bhx,bhxy->bhy", qt, cst)
        den = torch.maximum(
            torch.abs(torch.einsum("bhx,bhx->bh", qt, nst)), torch.exp(-mst))
        outs.append(num / den[..., None])
    return torch.stack(outs, dim=1)


def mlstm_decode(p, x, cfg, state):
    """Single-token mLSTM step (recurrent form)."""
    return mlstm_block(p, x, cfg, state=state, return_state=True)


# =====================================================================
# sLSTM — sequential scalar-memory LSTM with exponential gating
# =====================================================================

def slstm_spec(cfg) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    return {
        "wx": Param((d, h, 4, hd), ("embed", "heads", None, None)),
        "r": Param((h, hd, 4, hd), ("heads", None, None, None), "small"),
        "b": Param((h, 4, hd), ("heads", None, None), "zeros"),
        "norm": layers.rmsnorm_spec(d),
        "down": Param((d, d), ("embed", "embed")),
    }


def _slstm_step(p, xt, state, eps):
    """xt (B,H,4,hd) pre-projected; state = (c, n, h, m) each (B,H,hd)."""
    c, n, hprev, m = state
    rec = torch.einsum("bhx,hxgy->bhgy", hprev, p["r"].float())
    g = xt.float() + rec + p["b"].float()
    i_t, f_t, z_t, o_t = g[:, :, 0], g[:, :, 1], g[:, :, 2], g[:, :, 3]
    m_new = torch.maximum(f_t + m, i_t)
    i = torch.exp(i_t - m_new)
    f = torch.exp(f_t + m - m_new)
    c_new = f * c + i * torch.tanh(z_t)
    n_new = f * n + i
    h_new = torch.sigmoid(o_t) * c_new / torch.clamp(n_new, min=eps)
    return (c_new, n_new, h_new, m_new)


def slstm_block(p, x, cfg, state=None, return_state: bool = False):
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    xp = torch.einsum("bsd,dhgy->bshgy", x, p["wx"])
    if state is None:
        z = xp.new_zeros((b, h, hd), dtype=F32)
        state = (z, z, z, xp.new_full((b, h, hd), -1e30, dtype=F32))
    # on a mesh each rank runs its own heads: the batch over the DP axes,
    # the heads over the model axis where they divide into it
    xp = layers.placed(xp, model=2, dp=0)
    xl, r, bias, *st = layers.shards(
        xp, *(layers.placed(p[k], model=0) for k in ("r", "b")),
        *(layers.placed(t, model=1, dp=0) for t in state))
    rp, st = {"r": r, "b": bias}, tuple(st)
    hs = []
    for t in range(s):
        st = _slstm_step(rp, xl[:, t], st, 1e-6)
        hs.append(st[2])
    state = tuple(layers.sharded_like(t, xp, {0: 0, 2: 1}) for t in st)
    hs = layers.sharded_like(torch.stack(hs, dim=1), xp)
    hs = layers.merged(hs, (b, s, d)).to(x.dtype)
    hs = layers.rmsnorm(p["norm"], hs, cfg.norm_eps)
    out = torch.einsum("bsd,de->bse", hs, p["down"])
    if return_state:
        return out, state
    return out


def slstm_decode(p, x, cfg, state):
    return slstm_block(p, x, cfg, state=state, return_state=True)
