"""Public wrapper with the reference's signature for one leaf of a
masked fleet: mask-aware aggregation of a stack of per-tier updates,
one launch of the grouped ``fleet_aggregate`` kernel
(``csrc/fleet_aggregate.cu``) on a group of one leaf. A CUDA tensor
launches the kernel or raises; a CPU tensor takes the plain version.
There is no fallback from one to the other."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.fleet_aggregate import ops as fleet
from repro_torch.kernels.fleet_aggregate.ref import host_weights


def grad_aggregate(g: torch.Tensor, m: torch.Tensor, w, eps: float = 1e-8,
                   *, w_den=None) -> torch.Tensor:
    """g: (T, ...) stacked tier updates; m: the same shape, or (T,) /
    (T, 1) one scalar mask per tier; w, w_den: (T,) numerator and
    denominator weights (``w_den`` defaults to ``w``). Returns (...)."""
    t = g.shape[0]
    shape = tuple(g.shape[1:])
    m2 = m.reshape(t, -1)
    if m2.shape[1] not in (1, math.prod(shape)):
        raise ValueError(f"mask shape {tuple(m.shape)} does not match "
                         f"updates {tuple(g.shape)}")
    wn = host_weights(w, t)
    wd = wn if w_den is None else host_weights(w_den, t)
    before = fleet.fleet_aggregate.launches
    slab, (geo,), _ = fleet.aggregate(
        [(shape, list(zip(g.unbind(0), m2.unbind(0))))], wn, wd, eps)
    grad_aggregate.launches += fleet.fleet_aggregate.launches - before
    return slab.as_strided(geo.shape, geo.strides, 0)


grad_aggregate.launches = 0
