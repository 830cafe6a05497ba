"""llava-next-34b [vlm] — anyres tiling; LANGUAGE BACKBONE ONLY.

The ViT/SigLIP vision tower + projector is a STUB per the reproduction brief:
``input_specs()`` supplies precomputed patch embeddings (B, num_patches,
d_model) which the decoder consumes prepended to the text tokens (anyres
tiling yields a variable patch count; we fix 1152 = base 576 + one 576 tile).
[hf:llava-hf/llava-v1.6-mistral-7b-hf]
"""
from repro_torch.configs.base import ModelConfig, smoke_reduce


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family="vlm",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
        num_patches=1152,
        rope_theta=1_000_000.0,
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    )


def smoke_config() -> ModelConfig:
    return smoke_reduce(config())
