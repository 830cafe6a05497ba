"""Public wrappers with the reference's signatures for width-sliced
(structured) fleets: coverage-counted aggregation of per-tier prefix
blocks into one leaf, or into L same-signature leaves, through the
grouped ``fleet_aggregate`` kernel (``csrc/fleet_aggregate.cu``; L leaves
are one group, one launch per ``MAX_LEAVES``). A CUDA tensor launches
the kernel or raises; a CPU tensor takes the plain version. There is no
fallback from one to the other."""
from __future__ import annotations

import torch

from repro_torch.kernels.fleet_aggregate import ops as fleet
from repro_torch.kernels.fleet_aggregate.ref import host_weights
from repro_torch.kernels.structured_scatter.ref import leaf_views


def structured_scatter(gs, ms, w, w_den=None, *, out_shape: tuple,
                       eps: float = 1e-8) -> torch.Tensor:
    """Fused coverage-counted aggregation of one leaf across tiers.

    ``gs``/``ms``: per-tier update-sums and masks at each tier's LOCAL
    (prefix-sliced) shape; masks may be scalars. ``w``: (T,) numerator
    weights; ``w_den``: (T,) denominator weights (``w·n_participants``),
    defaulting to ``w``. ``out_shape``: the GLOBAL leaf shape. Returns
    the aggregated f32 leaf — bitwise ``scatter_accumulate`` ->
    ``finalize``."""
    res = structured_scatter_batched(
        [g[None] for g in gs], [torch.as_tensor(m)[None] for m in ms],
        w, w_den, out_shape=out_shape, eps=eps)
    return res[0]


def structured_scatter_batched(gs, ms, w, w_den=None, *, out_shape: tuple,
                               eps: float = 1e-8) -> torch.Tensor:
    """:func:`structured_scatter` over L same-signature leaves:
    ``gs[t]``/``ms[t]`` are stacked ``(L, *local_t)`` (masks may be
    ``(L,)`` scalars-per-leaf); ``out_shape`` is the single-leaf global
    shape; returns ``(L, *out_shape)``."""
    t = len(gs)
    wn = host_weights(w, t)
    wd = wn if w_den is None else host_weights(w_den, t)
    g3s, m3s, (L, R, C) = leaf_views(gs, ms, tuple(out_shape))
    before = fleet.fleet_aggregate.launches
    per_tier = [tuple(zip(g.unbind(0), m.unbind(0)))
                for g, m in zip(g3s, m3s)]
    slab, _, offs = fleet.aggregate(
        [((R, C), [tier[l] for tier in per_tier]) for l in range(L)],
        wn, wd, eps)
    structured_scatter.launches += fleet.fleet_aggregate.launches - before
    step = offs[1] - offs[0] if L > 1 else R * C
    return slab.as_strided((L, R * C), (step, 1), 0).reshape(
        (L,) + tuple(out_shape))


structured_scatter.launches = 0
