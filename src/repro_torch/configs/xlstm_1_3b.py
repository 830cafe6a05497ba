"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks. [arXiv:2405.04517]

d_ff=0: xLSTM blocks carry their own up/down projections (expand factor 2)
instead of a separate FFN. Every 8th layer is an sLSTM block (scalar memory,
strictly sequential); the rest are mLSTM (matrix memory, chunk-parallel).
"""
from repro_torch.configs.base import ModelConfig, smoke_reduce


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        slstm_every=8,
        ssm_expand=2,
        source="arXiv:2405.04517",
    )


def smoke_config() -> ModelConfig:
    return smoke_reduce(config())
