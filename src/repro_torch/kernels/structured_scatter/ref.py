"""Plain PyTorch version of the structured_scatter kernel: the per-leaf
``scatter_accumulate`` -> ``finalize`` chain of ``core/aggregation.py``,
op for op (the CUDA kernel is held BITWISE against it). The prefix-block
add is an in-place add on a slice, never an atomic scatter.

Geometry: every leaf is viewed 2-D row-major — ``rows =
prod(shape[:-1])`` (1 for 1-D leaves), ``cols = shape[-1]``. Width
slicing keeps mid axes full-size, so a tier whose local shape is
``local`` covers exactly rows ``[0, prod(local[:-1]))`` x cols ``[0,
local[-1])`` of that view: a true prefix block. Local shapes must come
from ``submodel_spec`` (or be full-shape).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.grad_aggregate.ops import host_weights


def view2d(shape: tuple) -> tuple[int, int]:
    """(rows, cols) of ``shape``'s row-major 2-D view."""
    return ((math.prod(shape[:-1]), shape[-1]) if len(shape) > 1
            else (1, shape[0] if shape else 1))


def leaf_views(gs, ms, out_shape: tuple):
    """Normalize per-tier stacks of L leaves to the kernel's operands.

    ``gs[t]``: (L, *local_t); ``ms[t]``: (L, *local_t), or one scalar
    per leaf ((L,) or any shape of L elements), or broadcastable to
    ``gs[t]``. Returns ``(g3s, m3s, scalar, (L, R, C))`` with
    ``g3s[t]`` (L, r_t, c_t) contiguous, ``m3s[t]`` (L,) when
    ``scalar[t]`` else (L, r_t, c_t)."""
    L = gs[0].shape[0]
    g3s, m3s, scalar = [], [], []
    for g, m in zip(gs, ms):
        r, c = view2d(tuple(g.shape[1:]))
        g3s.append(g.reshape(L, r, c).contiguous())
        m = torch.as_tensor(m, dtype=torch.float32, device=g.device)
        if m.numel() == L:
            m3s.append(m.reshape(L).contiguous())
            scalar.append(True)
            continue
        if m.numel() != g.numel():
            m = m.reshape((L,) + (1,) * (g.dim() - m.dim()) + tuple(m.shape[1:]))
            m = m.expand(g.shape)
        m3s.append(m.reshape(L, r, c).contiguous())
        scalar.append(False)
    return g3s, m3s, scalar, (L,) + view2d(tuple(out_shape))


def scatter_views_ref(gs, ms, scalar, wn, wd, out_lrc: tuple,
                      eps: float = 1e-8) -> torch.Tensor:
    """The aggregation over :func:`leaf_views` operands; ``wn``/``wd``
    are T Python floats (f32 values). Returns (L, R, C) f32."""
    num = torch.zeros(out_lrc, dtype=torch.float32, device=gs[0].device)
    den = torch.zeros_like(num)
    for g, m, sc, wn_t, wd_t in zip(gs, ms, scalar, wn, wd):
        if sc:
            m = m.reshape(-1, 1, 1)
        add_n = m * (wn_t * g)
        add_d = m * wd_t
        r, c = g.shape[-2:]
        if (r, c) == tuple(out_lrc[-2:]):
            num = num + add_n
            den = den + add_d
        else:
            num[..., :r, :c] += add_n
            den[..., :r, :c] += add_d
    return num / torch.clamp_min(den, eps)


def structured_scatter_ref(gs, ms, w, w_den=None, *, out_shape: tuple,
                           eps: float = 1e-8) -> torch.Tensor:
    """The reference's signature for one leaf: ``gs``/``ms`` per-tier
    local-shape update-sums and masks, ``w``/``w_den`` (T,) weights.
    Returns the aggregated f32 global leaf."""
    wn = host_weights(w, len(gs))
    wd = wn if w_den is None else host_weights(w_den, len(gs))
    g3s, m3s, scalar, lrc = leaf_views(
        [g[None] for g in gs], [torch.as_tensor(m)[None] for m in ms],
        tuple(out_shape))
    return scatter_views_ref(g3s, m3s, scalar, wn, wd, lrc, eps).reshape(
        tuple(out_shape))
