"""Plain PyTorch version of the masked_matmul kernel, the reference's
oracle (``masked_matmul_ref``): f32 product of x and w * mask, cast to
x's dtype. Differentiable by autograd, which gives the reference VJP's
dx = g @ (w*mask)^T and dw = (x^T @ g) * mask, and no mask gradient."""
from __future__ import annotations

import torch


def masked_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.float32)
            @ (w * mask.detach()).to(torch.float32)).to(x.dtype)
