"""Plain PyTorch version of the grad_aggregate kernel: the tier-ordered
``num + m*(wn*g)`` / ``den + m*wd`` chain, then the guarded divide —
the same arithmetic, in the same order, as the CUDA kernel and as
``core/aggregation.py``'s accumulate_cohort -> finalize."""
from __future__ import annotations

import torch


def grad_aggregate_ref(g: torch.Tensor, m: torch.Tensor, wn, wd,
                       eps: float = 1e-8) -> torch.Tensor:
    """g: (T, N); m: (T, N) or (T, 1); wn, wd: T Python floats (f32
    values). Returns (N,) f32."""
    num = torch.zeros(g.shape[1:], dtype=torch.float32, device=g.device)
    den = torch.zeros_like(num)
    for t in range(g.shape[0]):
        num = num + m[t] * (wn[t] * g[t])
        den = den + m[t] * wd[t]
    return num / torch.clamp_min(den, eps)
