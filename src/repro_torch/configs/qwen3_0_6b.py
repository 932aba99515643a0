"""qwen3-0.6b [dense] — 28L d1024 16H (GQA kv=8) ff3072 vocab151936.
qk-norm + GQA. [hf:Qwen/Qwen3-8B family; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv=8, d_ff=3072,
    vocab=151936, head_dim=128, qk_norm=True,
    tie_embeddings=True,
    block_pattern=(("attn", "mlp"),),
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-0.6B (qk_norm, GQA, head_dim=128)",
)
