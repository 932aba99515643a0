"""Assigned input shapes + abstract input specs for the dry run.

Four shapes per architecture (40 cells):
  train_4k     seq 4096,    global batch 256   -> train_step
  prefill_32k  seq 32768,   global batch 32    -> serve prefill
  decode_32k   1 new token, KV cache 32768, global batch 128 -> serve decode
  long_500k    1 new token, context 524288, global batch 1   -> serve decode
               (sub-quadratic archs only; dense-attention archs skip)

``input_specs`` returns tensors on the ``meta`` device only: shapes and
dtypes, nothing allocated (the port's counterpart of the reference's
``jax.ShapeDtypeStruct``s).
"""
from __future__ import annotations

from typing import Optional

import torch

from .base import ModelConfig, ShapeConfig

SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeConfig):
    """(runnable?, reason-if-skipped)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic():
        return False, (
            f"{cfg.name} uses full attention"
            + (" (enc-dec)" if cfg.cross_attention else "")
            + ": a 524288-token dense KV cache is the quadratic blow-up "
              "this shape excludes (DESIGN.md §5)")
    return True, ""


def token_count(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Text tokens per sample (frontends consume part of the budget)."""
    s = shape.seq_len
    if cfg.frontend == "vision":
        s = s - cfg.frontend_len
    return s


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                batch: Optional[int] = None) -> dict:
    """Abstract (meta-device) model inputs for a cell."""
    b = batch if batch is not None else shape.global_batch
    i32 = torch.int32
    dt = getattr(torch, cfg.dtype)
    if shape.kind == "train":
        s = token_count(cfg, shape)
        specs = {
            "tokens": _meta((b, s), i32),
            "targets": _meta((b, s), i32),
            "mask": _meta((b, s), torch.float32),
        }
    elif shape.kind == "prefill":
        s = token_count(cfg, shape)
        specs = {"tokens": _meta((b, s), i32)}
    elif shape.kind == "decode":
        specs = {
            "tokens": _meta((b, 1), i32),
            "pos": _meta((b,), i32),
        }
    else:
        raise ValueError(shape.kind)

    if cfg.frontend == "audio" and shape.kind != "decode":
        specs["enc_embeds"] = _meta((b, cfg.encoder_len, cfg.d_model), dt)
    if cfg.frontend == "vision" and shape.kind != "decode":
        specs["prefix_embeds"] = _meta((b, cfg.frontend_len, cfg.d_model), dt)
    return specs
