"""Config dataclasses for the model zoo, shapes, and runs.

The port's own copy of ``repro.configs.base`` (pure Python, value for
value), so that ``repro_torch`` never imports ``repro``."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    shared_expert: bool = False      # llama4: shared expert alongside routed
    router_z_loss: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    expand: float = 2.0              # d_inner = expand * d_model (mamba)
    conv_kernel: int = 4
    dt_rank: int = 0                 # 0 -> ceil(d_model / 16)
    chunk: int = 128                 # chunked-scan block length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    qk_norm: bool = False
    # layer pattern, cycled: entries from
    #   {"attn", "mlp", "moe", "mamba", "mlstm", "slstm", "hymba"}
    # each entry is one *residual sub-block*; a standard transformer layer is
    # ("attn", "mlp").
    block_pattern: Tuple[Tuple[str, ...], ...] = (("attn", "mlp"),)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    sliding_window: Optional[int] = None     # tokens; None = full attention
    rope_theta: float = 10000.0
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_len: int = 0                     # e.g. 1500 audio frames
    cross_attention: bool = False
    # modality frontend stub: precomputed embeddings prepended to the text
    frontend: Optional[str] = None           # "audio" | "vision"
    frontend_len: int = 0                    # patches / frames
    # numerics
    dtype: str = "float32"                   # activations / compute
    param_dtype: str = "float32"
    vocab_pad_multiple: int = 256
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_chunk: int = 1024                   # kv-chunk for online-softmax attn
    remat: str = "none"                      # none | full | dots
    constrain_acts: bool = False             # with_sharding_constraint on
    #                                          residual activations (§Perf)
    # notes for DESIGN/EXPERIMENTS (e.g. provenance of the config)
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_reps(self) -> int:
        assert self.n_layers % self.pattern_period == 0, \
            (self.name, self.n_layers, self.pattern_period)
        return self.n_layers // self.pattern_period

    def sub_quadratic(self) -> bool:
        """True if decode state is O(1) in context length (SSM/hybrid with
        sliding-window attention only)."""
        kinds = {b for grp in self.block_pattern for b in grp}
        has_full_attn = ("attn" in kinds and self.sliding_window is None) or \
            self.cross_attention
        return not has_full_attn

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    optimizer: str = "adamw"        # adamw | adafactor
    microbatch: int = 0             # 0 = no accumulation
    z_loss: float = 1e-4
    grad_compression: str = "none"  # none | int8 (DP axis, shard_map path)
    gather_once: bool = False       # all-gather FSDP params once per step
    #                                 (outside the microbatch scan), §Perf
    seed: int = 0


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            heads: int = 4, kv: int = 2, d_ff: int = 128, vocab: int = 512,
            experts: int = 4) -> ModelConfig:
    """Smoke-test scale-down that preserves the architecture family
    (pattern, MoE/SSM structure, frontends) while shrinking every dimension."""
    period = cfg.pattern_period
    layers = max(period, (layers // period) * period or period)
    kw = dict(
        n_layers=layers, d_model=d_model,
        n_heads=heads, n_kv=min(kv, heads), d_ff=d_ff, vocab=vocab,
        head_dim=d_model // heads,
        vocab_pad_multiple=64,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=experts,
            top_k=min(cfg.moe.top_k, experts), d_ff_expert=d_ff)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=8, chunk=32)
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
        kw["encoder_len"] = 16
    if cfg.frontend_len:
        kw["frontend_len"] = 8
    if cfg.sliding_window:
        kw["sliding_window"] = 16
    kw["attn_chunk"] = 64
    return cfg.replace(**kw)
