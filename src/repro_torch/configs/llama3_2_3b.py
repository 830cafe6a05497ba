"""llama3.2-3b [dense] — small llama3, GQA. [hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.configs.base import ModelConfig, smoke_reduce


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        rope_theta=500_000.0,
        tie_embeddings=True,
        source="hf:meta-llama/Llama-3.2-1B",
    )


def smoke_config() -> ModelConfig:
    return smoke_reduce(config())
