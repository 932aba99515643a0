"""qwen3-4b [dense] — 36L d2560 32H (GQA kv=8) ff9728 vocab151936."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv=8, d_ff=9728,
    vocab=151936, head_dim=128, qk_norm=True,
    tie_embeddings=True,
    block_pattern=(("attn", "mlp"),),
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-4B (qk_norm, GQA)",
)
