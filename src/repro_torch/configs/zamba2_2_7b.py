"""zamba2-2.7b [hybrid] — Mamba2 backbone + ONE shared attention block applied
every 6 layers (Zamba design: the attention block's parameters are shared
across all its applications). [arXiv:2411.15242]
"""
from repro_torch.configs.base import ModelConfig, smoke_reduce


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=10240,               # shared block's MLP hidden
        vocab_size=32000,
        ssm_state=64,
        ssm_headdim=64,
        ssm_expand=2,
        attn_every=6,
        source="arXiv:2411.15242",
    )


def smoke_config() -> ModelConfig:
    return smoke_reduce(config(), ssm_headdim=32)
