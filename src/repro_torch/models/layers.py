"""Dense layer building blocks. The weight layout is the reference's
``w: (d_in, d_out)`` (not ``nn.Linear``'s transpose): width slicing cuts
rows = ``d_in`` and cols = ``d_out``, and the aggregation kernels' 2-D
prefix views rely on that layout.

Leading batch axes are allowed on both sides: ``w`` may be
``(..., d_in, d_out)`` with ``b`` ``(..., d_out)`` — one weight set per
client of a cohort, the written-out client axis of the cohort runtime.
"""
from __future__ import annotations

import math

import torch


def init_dense(generator: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: float | None = None,
               device="cpu") -> dict[str, torch.Tensor]:
    """``{"b", "w"}`` (bias first: the leaf order of the reference's
    sorted-key flatten). ``w ~ N(0, 1) * scale``, drawn on the CPU from
    ``generator`` and moved to ``device``."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator,
                    dtype=torch.float32) * scale
    p = {}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=torch.float32, device=device)
    p["w"] = w.to(device)
    return p


def dense(w: torch.Tensor, b: torch.Tensor | None,
          x: torch.Tensor) -> torch.Tensor:
    """x: (..., n, d_in); w: (d_in, d_out) or (..., d_in, d_out)."""
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        b = b.to(x.dtype)
        y = y + (b.unsqueeze(-2) if w.dim() > 2 else b)
    return y
