"""Architecture config registry: ``get_config("llama3.2-3b")`` etc.

The decoder's three families (dense, MoE, VLM) are ported; the other
arch ids of the reference raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, smoke_reduce

# arch id -> module name (arch ids contain chars illegal in module names)
_ARCH_MODULES = {
    "granite-moe-1b-a400m": "granite_moe_1b",
    "granite-3-2b": "granite_3_2b",
    "llama3.2-3b": "llama3_2_3b",
    "deepseek-7b": "deepseek_7b",
    "llava-next-34b": "llava_next_34b",
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
}

# arch id -> the ROADMAP (queue 1) item that ports its family
_NOT_PORTED = {
    "xlstm-1.3b": "item 13 (xLSTM family)",
    "zamba2-2.7b": "item 14 (Zamba hybrid family)",
    "whisper-tiny": "item 15 (Whisper encoder-decoder)",
}

ARCHS = list(_ARCH_MODULES)


def _mod(arch: str):
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported yet: ROADMAP queue 1 {_NOT_PORTED[arch]}")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(_ARCH_MODULES) + sorted(_NOT_PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).smoke_config()


__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "ARCHS",
    "get_config", "get_smoke_config", "smoke_reduce",
]
