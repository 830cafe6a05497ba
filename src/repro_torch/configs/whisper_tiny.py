"""whisper-tiny [audio] — enc-dec; conv/mel frontend is a STUB.

The inputs are precomputed frame embeddings (B, 1500, d_model); the
model is the 4+4 layer encoder-decoder transformer with cross-attention.
Decode runs the decoder with cached encoder output + cross-KV.
[arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig, smoke_reduce


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="audio",
        num_layers=4,              # decoder layers
        encoder_layers=4,
        encoder_seq=1500,
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        tie_embeddings=True,
        source="arXiv:2212.04356",
    )


def smoke_config() -> ModelConfig:
    return smoke_reduce(config())
