"""Configuration dataclasses for architectures and input shapes.

The reference's dataclasses, verbatim. Every ported architecture gets one
module in this package defining ``config()`` (the full-scale config) and
``smoke_config()`` (a reduced same-family variant: <=2 layers,
d_model<=512, <=4 experts) used by the CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (transformer backbone only for vlm/audio)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int           # FFN hidden (per-expert hidden for MoE); 0 = no FFN
    vocab_size: int

    # attention
    head_dim: int = 0           # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # sliding-window attention; 0 = full causal. Used natively by archs that
    # have one, and as the long_500k sub-quadratic fallback (long_context_window).
    sliding_window: int = 0
    long_context_window: int = 8192

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (mamba2-style)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4

    # xLSTM: every `slstm_every`-th layer is an sLSTM block (rest mLSTM); 0 = n/a
    slstm_every: int = 0
    # zamba: one *shared* attention block applied after every `attn_every`
    # mamba layers; 0 = n/a
    attn_every: int = 0

    # encoder-decoder (whisper): encoder layer count + fixed encoder length
    encoder_layers: int = 0
    encoder_seq: int = 1500

    # VLM: number of stub image-patch embeddings prepended in train/prefill
    num_patches: int = 0

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"  # compute dtype (params kept f32)
    # use the flash-attention kernel (csrc/flash_attention.cu) instead of
    # the chunked path in attn_forward; a CPU tensor takes its plain version
    use_flash: bool = False

    # citation for the assigned config (paper/model card)
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_recurrent(self) -> bool:
        """Constant-size decode state (no growing KV cache)."""
        return self.family in ("ssm",)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def smoke_reduce(cfg: ModelConfig, **extra) -> ModelConfig:
    """Generic reduction: 2 layers, d_model<=512, <=4 experts, small vocab."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=min(cfg.d_model, 128),
        num_heads=min(cfg.num_heads, 4),
        num_kv_heads=min(cfg.num_kv_heads, 2),
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=0,
        long_context_window=64,
        dtype="float32",  # CPU smoke tests: accuracy over MXU realism
    )
    if cfg.is_moe:
        # capacity_factor 2.0 => dropless at smoke scale (decode-consistency
        # tests compare prefill vs decode token-exactly)
        kw.update(num_experts=4, experts_per_token=2, capacity_factor=2.0)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, encoder_seq=16)
    if cfg.attn_every:
        kw.update(attn_every=2)
    if cfg.slstm_every:
        kw.update(slstm_every=2)
    if cfg.num_patches:
        kw.update(num_patches=4)
    kw.update(extra)
    out = cfg.replace(**kw)
    # keep head_dim consistent with the reduced d_model
    object.__setattr__(out, "head_dim", out.d_model // out.num_heads)
    return out
