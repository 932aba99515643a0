"""phi-3-vision-4.2b [vlm] — 32L d3072 32H (MHA kv=32) ff8192 vocab32064.
CLIP frontend is a STUB: input_specs provides 576 precomputed patch
embeddings fused as a prefix.  [hf:microsoft/Phi-3-vision-128k-instruct]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv=32, d_ff=8192,
    vocab=32064, head_dim=96,
    block_pattern=(("attn", "mlp"),),
    frontend="vision", frontend_len=576,
    source="hf:microsoft/Phi-3-vision-128k-instruct (phi3-mini + CLIP stub)",
)
