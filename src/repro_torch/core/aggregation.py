"""Heterogeneous gradient aggregation (paper §3.2/§7.3): combine updates
from local models compressed differently into one update of the global
model, per coordinate

    g[i] = sum_t w_t * m_t[i] * g_t[i]  /  max(sum_t w_t * n_t * m_t[i], eps)

Masked tiers contribute full-shape masks through :func:`accumulate_cohort`;
width-sliced tiers scatter their sub-shaped update into the prefix block
of the same accumulators through :func:`scatter_accumulate`, which then
need dense denominators (``zeros_like_acc(params, dense_den=True)``).

Scalars (``weight``, ``count``) are Python floats holding f32 values; the
arithmetic is f32, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

EPS = 1e-8


def f32(x) -> float:
    """A Python float holding ``x`` rounded to f32 — how host scalars
    enter the f32 arithmetic (``f32(w) * f32(n)`` rounds like the
    reference's device-side f32 product)."""
    return float(np.float32(x))


def accumulate(acc, grads: dict, masks: dict, weight: float):
    """One tier's contribution (the per-client runtime's unit):

        num += (weight * masks) * grads
        den += weight * masks

    in the reference's association (``weight * m * g``)."""
    num, den = acc
    w = f32(weight)
    num = {k: a + (w * masks[k]) * grads[k] for k, a in num.items()}
    den = {k: a + w * masks[k] for k, a in den.items()}
    return num, den


def _scales(weight: float, count: float, staleness_weight):
    """(numerator scale, denominator scale) as f32 values: ``w`` (times
    the staleness weight when given) and ``w * count``, each product
    rounded to f32 as the reference's f32 scalars round it."""
    w = f32(weight)
    scale = w if staleness_weight is None else f32(w * f32(staleness_weight))
    return scale, f32(w * f32(count))


def accumulate_cohort(acc, grad_sum: dict, masks: dict, weight: float,
                      count: float, staleness_weight: float | None = None,
                      cov: dict | None = None):
    """A whole cohort's contribution in one shot:

        num += masks * (scale * grad_sum),  scale = weight * staleness_weight
        den += masks * (weight * count)     or masks * (weight * cov)

    ``staleness_weight`` is the async runtime's discount ``(1+s)^-a``. It
    scales the NUMERATOR only: a buffer of uniformly stale updates is
    damped absolutely (in both, a lone group's discount would cancel in
    :func:`finalize`). ``None`` is the synchronous contribution.

    Association invariant: the multiply feeding each add is the EXACT
    0/1-mask product, any inexact scalar product rounds one multiply
    earlier. The fused kernels rely on it to match this chain bitwise;
    do not rewrite it as ``a + weight * m * g``.

    ``cov`` is the fault layer's per-coordinate coverage: the
    participation-weighted sum of the cohort's 0/1 finite-guard masks.
    Given, it replaces ``count`` in the denominator, so a quarantined
    coordinate leaves it as it left the numerator. It is integer-valued,
    so ``weight * cov`` rounds as ``weight * count`` does; it needs dense
    denominators (``zeros_like_acc(dense_den=True)``).
    """
    num, den = acc
    scale, wc = _scales(weight, count, staleness_weight)
    w = f32(weight)
    num = {k: a + masks[k] * (scale * grad_sum[k]) for k, a in num.items()}
    den = {k: a + masks[k] * (wc if cov is None else w * cov[k])
           for k, a in den.items()}
    return num, den


def zeros_like_acc(params: dict, dense_den: bool = False):
    """(num, den) accumulators. Denominators are full-shape for >=2-D
    leaves and scalar otherwise, unless ``dense_den``."""
    num = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()}
    den = {k: torch.zeros(p.shape if (p.dim() >= 2 or dense_den) else (),
                          dtype=torch.float32, device=p.device)
           for k, p in params.items()}
    return num, den


def scatter_accumulate(acc, grad_sum: dict, masks: dict, spec,
                       weight: float, count: float,
                       staleness_weight: float | None = None,
                       cov: dict | None = None):
    """A structured cohort's contribution: each sliced leaf's update
    lands in the prefix block its width slice covers,

        num[:r, :c] += mask * (scale * grad_sum)
        den[:r, :c] += mask * (weight * count)

    (an add on a slice, never an atomic scatter). Unsliced leaves take
    :func:`accumulate_cohort`'s adds, and ``spec=None`` delegates to it;
    ``staleness_weight`` has its numerator-only meaning and ``cov`` (at
    the cohort's local shapes) its per-coordinate denominator meaning.
    """
    if spec is None:
        return accumulate_cohort(acc, grad_sum, masks, weight, count,
                                 staleness_weight, cov)
    num, den = dict(acc[0]), dict(acc[1])
    scale, wc = _scales(weight, count, staleness_weight)
    w = f32(weight)
    for k, sl in zip(num, spec.slices):
        add_n = masks[k] * (scale * grad_sum[k])
        add_d = masks[k] * (wc if cov is None else w * cov[k])
        if sl is None:
            num[k] = num[k] + add_n
            den[k] = den[k] + add_d
        else:
            idx = tuple(slice(0, n) for n in sl)
            n_k, d_k = num[k].clone(), den[k].clone()
            n_k[idx] += add_n
            d_k[idx] += add_d
            num[k], den[k] = n_k, d_k
    return num, den


def finalize(acc) -> dict:
    num, den = acc
    return {k: n / torch.clamp_min(den[k], EPS) for k, n in num.items()}


def hetero_aggregate(tier_grads: list[dict], tier_masks: list[dict],
                     weights) -> dict:
    """Direct aggregation over a list of tiers (the per-client
    runtime's): :func:`accumulate` each, then :func:`finalize`."""
    acc = zeros_like_acc(tier_grads[0])
    for g, m, w in zip(tier_grads, tier_masks, weights):
        acc = accumulate(acc, g, m, w)
    return finalize(acc)
