"""granite-3-8b [dense] — 40L d4096 32H (GQA kv=8) ff12800 vocab49155.
Vocab padded 49155 -> 49408 for 16-way TP (loss masks the pad)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv=8, d_ff=12800,
    vocab=49155, head_dim=128,
    block_pattern=(("attn", "mlp"),),
    rope_theta=1e4,
    source="hf:ibm-granite/granite-3.0-8b-base (GQA)",
)
