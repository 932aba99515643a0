"""Config registry: ``--arch <id>`` resolution (the ten architectures of
``repro.configs``, copied value for value)."""
from __future__ import annotations

import importlib

from .base import ModelConfig, MoEConfig, SSMConfig, ShapeConfig, \
    TrainConfig, reduced
from .shapes import SHAPES, applicable, input_specs, token_count

_MODULES = {
    "qwen3-0.6b": "qwen3_0_6b",
    "granite-3-8b": "granite_3_8b",
    "qwen3-4b": "qwen3_4b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "xlstm-1.3b": "xlstm_1_3b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "hymba-1.5b": "hymba_1_5b",
    "whisper-small": "whisper_small",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.CONFIG
