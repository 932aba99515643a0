"""hymba-1.5b [hybrid] — 32L d1600 25H (GQA kv=5) ff5504 ssm_state=16.
Parallel attention + mamba heads per layer, mean-fused; sliding-window
attention (1024) keeps decode state O(1).  [arXiv:2411.13676]"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv=5, d_ff=5504,
    vocab=32001, head_dim=64,
    block_pattern=(("hymba", "mlp"),),
    sliding_window=1024,
    ssm=SSMConfig(d_state=16, expand=2.0, chunk=128),
    source="arXiv:2411.13676 (parallel attn+mamba heads)",
)
