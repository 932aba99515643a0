"""xlstm-1.3b [ssm] — 48L d2048 4H, sLSTM + mLSTM blocks (7:1), d_ff=0.
expand=1.0 keeps the parameter count at the 1.3B point (DESIGN.md §5).
[arXiv:2405.04517]"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv=4, d_ff=0,
    vocab=50304,
    block_pattern=tuple([("mlstm",)] * 7 + [("slstm",)]),
    ssm=SSMConfig(d_state=16, expand=1.0, chunk=128),
    source="arXiv:2405.04517 (xLSTM[7:1]); unverified assignment",
)
