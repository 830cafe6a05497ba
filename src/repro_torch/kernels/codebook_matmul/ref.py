"""Plain PyTorch version of the codebook_matmul kernel, the reference's
oracle (``codebook_matmul_ref``): decode ``codebook[idx]`` and take the
f32 product, cast to x's dtype.

Indices are meant to lie in [0, n_codes). One outside follows the
oracle's JAX gather, not the TPU kernel (which gives 0.0): a negative
index counts from the end, then the result is clamped into range."""
from __future__ import annotations

import torch


def decode(idx: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """``codebook[idx]`` in f32 with the JAX gather's index rules."""
    n = codebook.shape[0]
    i = idx.to(torch.int64)
    i = torch.where(i < 0, i + n, i).clamp(0, n - 1)
    return codebook.to(torch.float32)[i]


def codebook_matmul_ref(x: torch.Tensor, idx: torch.Tensor,
                        codebook: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.float32) @ decode(idx, codebook)).to(x.dtype)
