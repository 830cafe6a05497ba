"""Magnitude pruning by a log-bisection threshold (the reference's
algorithm, step for step: 16 halvings of a 12-decade log interval, each
counting the kept fraction with an elementwise compare and a mean).
``topk`` or ``quantile`` would break ties differently, so neither is
used.

Leading ``batch`` axes hold independent tensors (one per client of a
cohort): each gets its own threshold over its trailing axes.
"""
from __future__ import annotations

import torch

ITERS = 16
EPS = 1e-12            # dynamic range of the log search (12 decades)
TINY = 2.0 ** -126     # the least normal f32


def _flush(x: torch.Tensor) -> torch.Tensor:
    """x with f32 subnormals flushed to 0, as the reference's backends
    (XLA on the CPU, the TPU) compute the threshold's bounds: for a leaf
    whose largest |w| is below ~1e-26 (an all-zero bias at init) the
    lower bound amax * EPS is subnormal, the reference's is 0, and its
    mask keeps every weight."""
    return torch.where(x.abs() < TINY, torch.zeros_like(x), x)


def _threshold(aw: torch.Tensor, density: float, batch: int) -> torch.Tensor:
    """|w| threshold such that ~`density` fraction of weights survive,
    one per leading batch index (kept broadcastable)."""
    dims = tuple(range(batch, aw.dim()))
    amax = torch.amax(aw, dim=dims, keepdim=True) + 1e-30
    lo = torch.log(_flush(amax * EPS))  # kept-fraction(exp(lo)) ~ 1
    hi = torch.log(amax)                # kept-fraction(exp(hi)) ~ 0
    n = float(aw[(0,) * batch].numel())
    for _ in range(ITERS):
        mid = 0.5 * (lo + hi)
        # sum / n, as the reference's mean: an exact count over an exact
        # divide, so `kept > density` decides alike at kept == density
        kept = torch.sum((aw >= _flush(torch.exp(mid))).to(torch.float32),
                         dim=dims, keepdim=True) / n
        # too many kept -> raise the threshold (move lo up), else lower hi
        up = kept > density
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    return _flush(torch.exp(lo))  # the >=density side of the bracket


@torch.no_grad()
def magnitude_mask(w: torch.Tensor, density: float,
                   batch: int = 0) -> torch.Tensor:
    """0/1 keep-mask, same dtype as w, never differentiated.
    density >= 1.0 short-circuits to all-ones."""
    if density >= 1.0:
        return torch.ones_like(w)
    aw = w.abs()
    return (aw >= _threshold(aw, density, batch)).to(w.dtype)
