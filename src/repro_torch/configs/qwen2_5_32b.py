"""qwen2.5-32b [dense] — GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B]"""
from repro_torch.configs.base import ModelConfig, smoke_reduce


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=27648,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen2.5-0.5B",
    )


def smoke_config() -> ModelConfig:
    return smoke_reduce(config())
