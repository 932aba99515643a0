"""granite-moe-1b-a400m [moe] — 24L d1024 16H (GQA kv=8) expert-ff 512,
vocab 49155, 32 experts top-8."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv=8, d_ff=512,
    vocab=49155, head_dim=64,
    block_pattern=(("attn", "moe"),),
    tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512,
                  capacity_factor=1.25),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (32e top-8)",
)
