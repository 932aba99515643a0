"""deepseek-coder-33b [dense] — 62L d7168 56H (GQA kv=8) ff19200 vocab32256.
Llama architecture. [arXiv:2401.14196]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv=8, d_ff=19200,
    vocab=32256, head_dim=128,
    block_pattern=(("attn", "mlp"),),
    rope_theta=1e5,
    remat="dots",
    source="arXiv:2401.14196 (llama-arch)",
)
