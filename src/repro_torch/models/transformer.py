"""Model assembly: decoder-only LM, encoder-decoder (whisper), VLM fusion
(the port of ``repro.models.transformer``).

Layers are grouped into a repeating *unit* (``cfg.block_pattern``).  The
reference stacks the unit's parameters on a leading "layers" axis and runs
``lax.scan``; here each repetition is its own entry of an ``nn.ModuleList``
(``ParamTree``), and ``apply_stack`` loops over them.  The cache follows the
modules: a list with one unit dict per repetition.

Sub-block kinds:
  attn   — GQA self-attention (sliding window if cfg.sliding_window)
  cross  — cross-attention to encoder memory (whisper decoder)
  mlp    — SwiGLU           gmlp — GELU MLP (whisper)
  moe    — routed experts   mamba/mlstm/slstm — recurrent blocks
  hymba  — parallel attn + mamba heads on the same normed input, mean-fused
           (arXiv:2411.13676)

``remat`` (``cfg.remat``, or the ``remat`` argument) recomputes each
repetition's activations in the backward pass: ``"full"`` keeps only the
unit's inputs, ``"dots"`` keeps the products' outputs (``mm``, ``bmm``,
``addmm``: what the reference's ``checkpoint_dots`` keeps of its
``dot_general``s) and recomputes the rest.
"""
from __future__ import annotations

from typing import List

import torch
from torch.distributed.tensor import DTensor
from torch.utils import checkpoint as ckpt_lib

from . import attention as attn_lib
from . import layers, moe as moe_lib, ssm as ssm_lib
from .params import Param, stack_spec


# ------------------------------------------------------------- block specs

def sub_block_spec(kind: str, cfg) -> dict:
    d = cfg.d_model
    spec = {"norm": layers.rmsnorm_spec(d)}
    if kind == "attn":
        spec["attn"] = attn_lib.attention_spec(cfg)
    elif kind == "cross":
        spec["attn"] = attn_lib.attention_spec(cfg, cross=True)
    elif kind == "mlp":
        spec["mlp"] = layers.swiglu_spec(d, cfg.d_ff)
    elif kind == "gmlp":
        spec["mlp"] = layers.gelu_mlp_spec(d, cfg.d_ff)
    elif kind == "moe":
        spec["moe"] = moe_lib.moe_spec(cfg)
    elif kind == "mamba":
        spec["mamba"] = ssm_lib.mamba_spec(cfg)
    elif kind == "mlstm":
        spec["mlstm"] = ssm_lib.mlstm_spec(cfg)
    elif kind == "slstm":
        spec["slstm"] = ssm_lib.slstm_spec(cfg)
    elif kind == "hymba":
        spec["attn"] = attn_lib.attention_spec(cfg)
        spec["mamba"] = ssm_lib.mamba_spec(cfg)
    else:
        raise ValueError(kind)
    return spec


def unit_spec(cfg, decoder: bool) -> dict:
    out = {}
    for i, group in enumerate(cfg.block_pattern):
        g = {}
        for kind in group:
            g[kind] = sub_block_spec(kind, cfg)
        if decoder and cfg.cross_attention:
            g["cross"] = sub_block_spec("cross", cfg)
        out[f"layer{i}"] = g
    return out


def lm_spec(cfg) -> dict:
    spec = {
        "embed": layers.embedding_spec(cfg.padded_vocab, cfg.d_model),
        "final_norm": layers.rmsnorm_spec(cfg.d_model),
        "layers": stack_spec(unit_spec(cfg, decoder=True), cfg.n_reps),
    }
    if not cfg.tie_embeddings:
        spec["head"] = layers.output_head_spec(cfg.d_model, cfg.padded_vocab)
    if cfg.encoder_layers:
        enc_cfg = cfg
        spec["encoder"] = {
            "layers": stack_spec(
                {"layer0": {"attn": sub_block_spec("attn", enc_cfg),
                            "gmlp": sub_block_spec("gmlp", enc_cfg)}},
                cfg.encoder_layers),
            "final_norm": layers.rmsnorm_spec(cfg.d_model),
        }
    if cfg.frontend == "vision":
        spec["vision_adapter"] = {
            "proj": Param((cfg.d_model, cfg.d_model), ("embed", "embed"))}
    if cfg.frontend == "audio":
        spec["audio_adapter"] = {
            "proj": Param((cfg.d_model, cfg.d_model), ("embed", "embed"))}
    return spec


# ------------------------------------------------------------ cache specs

def _dt(cfg):
    return getattr(torch, cfg.dtype)


def sub_block_cache(kind: str, cfg, batch: int, cache_len: int, device):
    """Zero cache entry for one sub-block (decode mode)."""
    hd, kv = cfg.hd, cfg.n_kv
    f32 = torch.float32

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if kind in ("attn", "hymba"):
        win = cfg.sliding_window
        clen = min(cache_len, win) if win else cache_len
        entry = {"k": zeros((batch, clen, kv, hd), _dt(cfg)),
                 "v": zeros((batch, clen, kv, hd), _dt(cfg))}
        if kind == "hymba":
            di, _, ds, kc = ssm_lib.mamba_dims(cfg)
            entry.update(h=zeros((batch, di, ds), f32),
                         conv=zeros((batch, kc - 1, di), _dt(cfg)))
        return entry
    if kind == "mamba":
        di, _, ds, kc = ssm_lib.mamba_dims(cfg)
        return {"h": zeros((batch, di, ds), f32),
                "conv": zeros((batch, kc - 1, di), _dt(cfg))}
    if kind == "mlstm":
        di, h, hd2 = ssm_lib.mlstm_dims(cfg)
        return {"c": zeros((batch, h, hd2, hd2), f32),
                "n": zeros((batch, h, hd2), f32),
                "m": torch.full((batch, h), -1e30, dtype=f32, device=device)}
    if kind == "slstm":
        h = cfg.n_heads
        hd2 = cfg.d_model // h
        z = zeros((batch, h, hd2), f32)
        return {"c": z, "n": z, "h": z,
                "m": torch.full((batch, h, hd2), -1e30, dtype=f32,
                                device=device)}
    if kind == "cross":
        # memory k/v filled at prefill from the encoder output
        return {"k": zeros((batch, cfg.encoder_len, cfg.n_heads, hd),
                           _dt(cfg)),
                "v": zeros((batch, cfg.encoder_len, cfg.n_heads, hd),
                           _dt(cfg))}
    if kind in ("mlp", "gmlp", "moe"):
        return {}
    raise ValueError(kind)


def init_cache(cfg, batch: int, cache_len: int, device="cpu") -> List[dict]:
    """One zero unit cache per repetition of the block pattern."""
    def unit():
        out = {}
        for i, group in enumerate(cfg.block_pattern):
            g = {kind: sub_block_cache(kind, cfg, batch, cache_len, device)
                 for kind in group}
            if cfg.cross_attention:
                g["cross"] = sub_block_cache("cross", cfg, batch, cache_len,
                                             device)
            out[f"layer{i}"] = g
        return out
    return [unit() for _ in range(cfg.n_reps)]


# -------------------------------------------------------------- sub-blocks

def _index_write(c, idx, new):
    """``c[:, idx] = new`` into ``c`` (the caller's copy), returned.  On a
    mesh the sequence dim of ``c`` is sharded (``rules.cache_shardings``)
    and DTensor has no rule for an index write into it: the write runs on
    each rank's copy of the whole sequence, laid out as ``c`` after."""
    if not isinstance(c, DTensor):
        c[:, idx] = new
        return c
    whole, new = layers.placed(c, dp=0), layers.placed(new, dp=0)
    cl, nl = layers.shards(whole, new)
    cl[:, idx] = nl
    return layers.sharded_like(cl, whole).redistribute(c.device_mesh,
                                                       c.placements)


def apply_sub(kind: str, p, x, cfg, *, positions, mode: str, cache=None,
              pos=None, memory=None):
    """One residual sub-block on pre-normed input.  Returns
    (delta, new_cache, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ("mlp",):
        return layers.swiglu(p["mlp"], x), cache, aux
    if kind == "gmlp":
        return layers.gelu_mlp(p["mlp"], x), cache, aux
    if kind == "moe":
        y, aux = moe_lib.moe_block(p["moe"], x, cfg)
        return y, cache, aux

    if kind in ("attn", "hymba"):
        ap = p["attn"]
        win = cfg.sliding_window
        if mode == "decode":
            q, k_new, v_new = attn_lib.project_qkv(
                ap, cfg, x, x, pos[:, None], pos[:, None])
            if win:
                kc, vc = attn_lib.update_window_cache(
                    cache["k"], cache["v"], k_new, v_new, pos)
                ctx = attn_lib.decode_window_attention(q, kc, vc, pos, win)
            else:
                kc, vc = attn_lib.update_cache(
                    cache["k"], cache["v"], k_new, v_new, pos)
                ctx = attn_lib.decode_attention(q, kc, vc, pos, window=win)
            new_cache = dict(cache, k=kc, v=vc)
        else:
            q, k, v = attn_lib.project_qkv(ap, cfg, x, x, positions, positions)
            s = x.shape[1]
            if s <= 2 * cfg.attn_chunk:
                ctx = attn_lib.full_attention(q, k, v, causal=True, window=win)
            else:
                ctx = attn_lib.chunked_attention(
                    q, k, v, causal=True, chunk=cfg.attn_chunk, window=win)
            new_cache = cache
            if mode == "prefill" and cache is not None:
                clen = cache["k"].shape[1]
                kc, vc = cache["k"].clone(), cache["v"].clone()
                if win:
                    # keep the trailing window in ring order
                    m = min(s, clen)
                    idx = torch.arange(s - m, s, device=x.device) % clen
                    kc = _index_write(kc, idx, k[:, -m:])
                    vc = _index_write(vc, idx, v[:, -m:])
                else:
                    if s > clen:
                        raise ValueError(f"prefill of {s} tokens does not "
                                         f"fit a cache of {clen}")
                    kc[:, :s] = k
                    vc[:, :s] = v
                new_cache = dict(cache, k=kc, v=vc)
        y_attn = attn_lib.output_proj(ap, ctx)
        if kind == "attn":
            return y_attn, new_cache, aux

        # hymba: parallel mamba head on the same normed input, mean fusion
        if mode == "decode":
            y_m, (h_new, conv_new) = ssm_lib.mamba_decode(
                p["mamba"], x, cfg, (cache["h"], cache["conv"]))
            new_cache = dict(new_cache, h=h_new, conv=conv_new)
        elif mode == "prefill" and cache is not None:
            y_m, (h_new, conv_new) = ssm_lib.mamba_block(
                p["mamba"], x, cfg, return_state=True)
            new_cache = dict(new_cache, h=h_new, conv=conv_new)
        else:
            y_m = ssm_lib.mamba_block(p["mamba"], x, cfg)
        return (y_attn + y_m) * 0.5, new_cache, aux

    if kind == "cross":
        ap = p["attn"]
        q = torch.einsum("bsd,dhx->bshx", x, ap["wq"])
        if mode == "decode":
            ctx = attn_lib.decode_attention(
                q, cache["k"], cache["v"],
                torch.full((x.shape[0],), cache["k"].shape[1] - 1,
                           dtype=torch.int32, device=x.device))
            new_cache = cache
        else:
            k = torch.einsum("bsd,dkx->bskx", memory, ap["wk"])
            v = torch.einsum("bsd,dkx->bskx", memory, ap["wv"])
            ctx = attn_lib.full_attention(q, k, v, causal=False)
            new_cache = dict(cache, k=k, v=v) if cache is not None else cache
        return attn_lib.output_proj(ap, ctx), new_cache, aux

    if kind == "mamba":
        if mode == "decode":
            y, (h, conv) = ssm_lib.mamba_decode(
                p["mamba"], x, cfg, (cache["h"], cache["conv"]))
            return y, dict(cache, h=h, conv=conv), aux
        if mode == "prefill" and cache is not None:
            y, (h, conv) = ssm_lib.mamba_block(p["mamba"], x, cfg,
                                               return_state=True)
            return y, dict(cache, h=h, conv=conv), aux
        return ssm_lib.mamba_block(p["mamba"], x, cfg), cache, aux

    if kind == "mlstm":
        st = (cache["c"], cache["n"], cache["m"]) if cache else None
        if mode == "decode" or (mode == "prefill" and cache is not None):
            y, (c, n, m) = ssm_lib.mlstm_block(p["mlstm"], x, cfg, state=st
                                               if mode == "decode" else None,
                                               return_state=True)
            return y, dict(cache, c=c, n=n, m=m), aux
        return ssm_lib.mlstm_block(p["mlstm"], x, cfg), cache, aux

    if kind == "slstm":
        st = (cache["c"], cache["n"], cache["h"], cache["m"]) \
            if cache else None
        if mode == "decode" or (mode == "prefill" and cache is not None):
            y, (c, n, h, m) = ssm_lib.slstm_block(
                p["slstm"], x, cfg,
                state=st if mode == "decode" else None, return_state=True)
            return y, dict(cache, c=c, n=n, h=h, m=m), aux
        return ssm_lib.slstm_block(p["slstm"], x, cfg), cache, aux

    raise ValueError(kind)


# ------------------------------------------------------------------ units

def _constrain_dp(x, cfg):
    """The residual stream's layout before each sub-block and the head.
    The reference pins its batch dim to the DP mesh axes here (under
    ``constrain_acts``; XLA's propagation places it otherwise).  On a mesh
    the port pins it always: the batch over the DP axes
    (``rules.batch_sharding``), the model axis replicated
    (``layers.placed``): unpinned, the stream drifts into layouts (the
    sequence or d_model split over the model axis) that later views
    cannot split.  Outside a mesh it returns its input."""
    return layers.placed(x, dp=0)


def apply_unit(up, x, cfg, *, positions, mode, cache=None, pos=None,
               memory=None, decoder=True):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = {} if cache is not None else None
    for i, group in enumerate(cfg.block_pattern):
        lname = f"layer{i}"
        lp = up[lname]
        lcache = cache[lname] if cache is not None else None
        lnew = {}
        kinds = list(group)
        if decoder and cfg.cross_attention:
            # interleave cross-attention after self-attention
            out_kinds = []
            for kd in kinds:
                out_kinds.append(kd)
                if kd == "attn":
                    out_kinds.append("cross")
            kinds = out_kinds
        for kind in kinds:
            bp = lp[kind]
            x = _constrain_dp(x, cfg)
            h = layers.rmsnorm(bp["norm"], x, cfg.norm_eps)
            delta, kc, a = apply_sub(
                kind, bp, h, cfg, positions=positions, mode=mode,
                cache=(lcache.get(kind) if lcache is not None else None),
                pos=pos, memory=memory)
            x = x + delta
            aux = aux + a
            if new_cache is not None:
                lnew[kind] = kc if kc is not None else {}
        if new_cache is not None:
            new_cache[lname] = lnew
    return x, new_cache, aux


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``."""
    return (ckpt_lib.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt_lib.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_unit(remat: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with its activations recomputed in the
    backward pass as ``remat`` says ("full" or "dots")."""
    if remat == "full":
        return ckpt_lib.checkpoint(fn, *args, use_reentrant=False, **kwargs)
    if remat == "dots":
        return ckpt_lib.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: ckpt_lib.create_selective_checkpoint_contexts(
                _save_dots), **kwargs)
    raise ValueError(f"unknown remat {remat!r}")


def apply_stack(units, x, cfg, *, positions, mode, cache=None, pos=None,
                memory=None, decoder=True, remat=None):
    """Run the repeating unit once per repetition (``units``: the
    ModuleList, or a list of per-repetition parameter trees).  ``remat``
    defaults to ``cfg.remat``; it changes what autograd keeps, not the
    values, and applies only where autograd records."""
    remat = remat if remat is not None else cfg.remat
    recompute = remat not in (None, "none") and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = [] if cache is not None else None
    for r, up in enumerate(units):
        kw = dict(positions=positions, mode=mode,
                  cache=cache[r] if cache is not None else None, pos=pos,
                  memory=memory, decoder=decoder)
        if recompute:
            x, nc, a = _remat_unit(remat, apply_unit, up, x, cfg, **kw)
        else:
            x, nc, a = apply_unit(up, x, cfg, **kw)
        aux = aux + a
        if new_cache is not None:
            new_cache.append(nc)
    return x, new_cache, aux


# ------------------------------------------------------------------ models

def encode(params, cfg, enc_embeds):
    """Whisper-style encoder over precomputed frame embeddings (B, L, d)."""
    d = cfg.d_model
    pos_emb = layers.sinusoidal_positions(enc_embeds.shape[1], d,
                                          enc_embeds.dtype, enc_embeds.device)
    x = enc_embeds + pos_emb[None]
    if "audio_adapter" in params:
        x = torch.einsum("bld,de->ble", x, params["audio_adapter"]["proj"])
    ecfg = cfg.replace(block_pattern=(("attn", "gmlp"),),
                       cross_attention=False, sliding_window=None,
                       n_layers=cfg.encoder_layers)
    ar = torch.arange(x.shape[1], device=x.device)
    for up in params["encoder"]["layers"]:
        # encoder attention is bidirectional: full attention, no RoPE
        lp = up["layer0"]
        for kind in ("attn", "gmlp"):
            bp = lp[kind]
            h = layers.rmsnorm(bp["norm"], x, cfg.norm_eps)
            if kind == "attn":
                q, k, v = attn_lib.project_qkv(bp["attn"], ecfg, h, h, ar, ar,
                                               rope=False)
                ctx = attn_lib.full_attention(q, k, v, causal=False)
                x = x + attn_lib.output_proj(bp["attn"], ctx)
            else:
                x = x + layers.gelu_mlp(bp["mlp"], h)
    return layers.rmsnorm(params["encoder"]["final_norm"], x, cfg.norm_eps)


def forward(params, cfg, tokens, *, mode: str = "train", cache=None,
            pos=None, prefix_embeds=None, enc_embeds=None, remat=None):
    """Top-level forward.

    tokens (B, S) integer; prefix_embeds (B, P, d) for VLM; enc_embeds
    (B, L, d) for audio.  Returns (logits, new_cache, aux_loss).
    """
    x = layers.embed(params["embed"], tokens.long()).to(_dt(cfg))
    offset = 0
    if prefix_embeds is not None:
        pe = torch.einsum("bpd,de->bpe", prefix_embeds.to(_dt(cfg)),
                          params["vision_adapter"]["proj"])
        x = torch.cat([pe, x], dim=1)
        offset = prefix_embeds.shape[1]
    memory = None
    if cfg.encoder_layers and enc_embeds is not None:
        memory = encode(params, cfg, enc_embeds.to(_dt(cfg)))

    if mode == "decode":
        positions = None
    else:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]

    x, new_cache, aux = apply_stack(
        params["layers"], x, cfg, positions=positions, mode=mode,
        cache=cache, pos=pos, memory=memory, remat=remat)
    x = layers.rmsnorm(params["final_norm"], _constrain_dp(x, cfg),
                       cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = layers.unembed(params["embed"], x)
    else:
        logits = layers.output_head(params["head"], x)
    if offset:
        logits = logits[:, offset:]
    return logits, new_cache, aux
