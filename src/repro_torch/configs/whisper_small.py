"""whisper-small [audio] — 12L enc + 12L dec, d768 12H ff3072 vocab51865.
Conv frontend is a STUB: input_specs provides 1500 precomputed frame
embeddings.  Decoder self-attention uses RoPE (deviation from learned
positions, noted in DESIGN.md).  [arXiv:2212.04356]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv=12, d_ff=3072,
    vocab=51865, head_dim=64,
    block_pattern=(("attn", "gmlp"),),
    tie_embeddings=True,
    encoder_layers=12, encoder_len=1500, cross_attention=True,
    frontend="audio",
    source="arXiv:2212.04356 (enc-dec, conv frontend stubbed)",
)
