"""llama4-maverick-400b-a17b [moe] — 48L d5120 40H (GQA kv=8) ff8192,
vocab 202048, MoE 128e top-1, interleaved dense/MoE + shared expert
(to land at ~400B total / ~17B active; DESIGN.md §5).  Adafactor state."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=8192,
    vocab=202048, head_dim=128,
    block_pattern=(("attn", "mlp"), ("attn", "moe")),
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192,
                  capacity_factor=1.25, shared_expert=True),
    dtype="bfloat16", param_dtype="bfloat16",
    remat="dots",
    source="hf:meta-llama/Llama-4-Maverick family; unverified assignment",
)
