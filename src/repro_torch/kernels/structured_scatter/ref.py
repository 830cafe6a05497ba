"""Plain PyTorch version of ``structured_scatter``: the per-leaf
``scatter_accumulate`` -> ``finalize`` chain of ``core/aggregation.py``,
op for op (``fleet_aggregate/ref.py``), after the public signature's
inputs are put in the grouped kernel's form (:func:`leaf_views`). Local
shapes must come from ``submodel_spec`` (or be full-shape).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fleet_aggregate.ref import (aggregate_leaf_ref,
                                                     host_weights, view2d)


def leaf_views(gs, ms, out_shape: tuple):
    """Normalize per-tier stacks of L leaves to the grouped kernel's
    operands.

    ``gs[t]``: (L, *local_t); ``ms[t]``: (L, *local_t), or one scalar
    per leaf ((L,) or any shape of L elements), or broadcastable to
    ``gs[t]``. Returns ``(g3s, m3s, (L, R, C))`` with ``g3s[t]`` (L,
    r_t, c_t) contiguous and ``m3s[t]`` (L,) for scalar masks, else as
    ``g3s[t]``."""
    L = gs[0].shape[0]
    g3s, m3s = [], []
    for g, m in zip(gs, ms):
        r, c = view2d(tuple(g.shape[1:]))
        g3s.append(g.reshape(L, r, c).contiguous())
        m = torch.as_tensor(m, dtype=torch.float32, device=g.device)
        if m.numel() == L:
            m3s.append(m.reshape(L).contiguous())
            continue
        if m.numel() != g.numel():
            m = m.reshape((L,) + (1,) * (g.dim() - m.dim()) + tuple(m.shape[1:]))
            m = m.expand(g.shape)
        m3s.append(m.reshape(L, r, c).contiguous())
    return g3s, m3s, (L,) + view2d(tuple(out_shape))


def structured_scatter_ref(gs, ms, w, w_den=None, *, out_shape: tuple,
                           eps: float = 1e-8) -> torch.Tensor:
    """The reference's signature for one leaf: ``gs``/``ms`` per-tier
    local-shape update-sums and masks, ``w``/``w_den`` (T,) weights.
    Returns the aggregated f32 global leaf."""
    wn = host_weights(w, len(gs))
    wd = wn if w_den is None else host_weights(w_den, len(gs))
    g3s, m3s, (_, R, C) = leaf_views(
        [g[None] for g in gs], [torch.as_tensor(m)[None] for m in ms],
        tuple(out_shape))
    return aggregate_leaf_ref((R, C), [(g[0], m[0]) for g, m in zip(g3s, m3s)],
                              wn, wd, eps).reshape(tuple(out_shape))
