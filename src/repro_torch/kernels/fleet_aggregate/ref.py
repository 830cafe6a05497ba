"""Plain PyTorch version of the fleet_aggregate kernel: for one leaf,
the ``accumulate_cohort`` / ``scatter_accumulate`` -> ``finalize`` chain
of ``core/aggregation.py``, op for op (the CUDA kernel is held BITWISE
against it). A width-sliced tier's add is an in-place add on the prefix
block it covers, never an atomic scatter.

Geometry: every leaf is viewed 2-D row-major — ``rows =
prod(shape[:-1])`` (1 for 1-D and 0-d leaves), ``cols = shape[-1]``.
Width slicing keeps mid axes full-size, so a tier whose local shape is
``local`` covers exactly rows ``[0, prod(local[:-1]))`` x cols ``[0,
local[-1])`` of that view: a true prefix block.
"""
from __future__ import annotations

import math
from array import array

import numpy as np
import torch


def host_weights(w, t: int) -> list[float]:
    """T weights (a sequence, an array or a tensor; a CUDA tensor is read
    back to the host) as Python floats holding f32 values, in one
    conversion (round to nearest, as ``aggregation.f32``)."""
    if isinstance(w, (torch.Tensor, np.ndarray)):
        w = w.reshape(-1).tolist()
    w = array("f", w).tolist()
    if len(w) != t:
        raise ValueError(f"{len(w)} weights for {t} tiers")
    return w


def view2d(shape: tuple) -> tuple[int, int]:
    """(rows, cols) of ``shape``'s row-major 2-D view."""
    return ((math.prod(shape[:-1]), shape[-1]) if len(shape) > 1
            else (1, shape[0] if shape else 1))


def aggregate_leaf_ref(shape: tuple, tiers, wn, wd,
                       eps: float = 1e-8) -> torch.Tensor:
    """One leaf of global ``shape``: ``tiers`` is T ``(g, m)`` pairs, g at
    the tier's local (prefix-block) shape, m as g or one value; ``wn``,
    ``wd``: T Python floats holding f32 values. Returns ``shape`` f32."""
    R, C = view2d(tuple(shape))
    num = torch.zeros((R, C), dtype=torch.float32, device=tiers[0][0].device)
    den = torch.zeros_like(num)
    for (g, m), wn_t, wd_t in zip(tiers, wn, wd):
        r, c = view2d(tuple(g.shape))
        m = m.reshape(()) if m.numel() == 1 else m.reshape(r, c)
        add_n = m * (wn_t * g.reshape(r, c))
        add_d = m * wd_t
        if (r, c) == (R, C):
            num = num + add_n
            den = den + add_d
        else:
            num[:r, :c] += add_n
            den[:r, :c] += add_d
    return (num / torch.clamp_min(den, eps)).reshape(tuple(shape))
