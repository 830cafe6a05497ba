"""Apply a compression plan to a whole parameter dict.

Only matrix-shaped leaves (``compressible``) are compressed; 1-D leaves
and the MoE router stay full precision. Two entry points:
``compress_with_masks`` (prune + quant, the tier loop of the LM train
step) and ``compress_params`` (adds clustering and width slicing, the FL
runtimes and serving). For STRUCTURED plans the
returned ``cparams`` live at the LOCAL (sliced) shapes while ``masks``
stay at GLOBAL shapes, naming exactly the global coordinates the tier's
update covers.

``batch`` leading axes hold one independent copy per client (FedAvg
re-compresses every client's weights after each local step); masks and
codebooks are then per client.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.compression.clustering import cluster_ste
from repro_torch.core.compression.plan import CompressionPlan
from repro_torch.core.compression.pruning import (magnitude_masks,
                                                   split_axes)
from repro_torch.core.compression.quantization import fake_quant_ste
from repro_torch.core.compression.structured import (compressible,
                                                     expand_masks, slice_tree,
                                                     submodel_spec)

__all__ = ["compressible", "compress_with_masks", "compress_params",
           "payload_bits", "active_param_count"]


def _int_scale(x: torch.Tensor, bits: int, sharding):
    """int-k's step for this rank's block ``x`` of a leaf split over ranks
    ("model", the data axes, or both): the whole leaf's max / qmax, the
    max all-reduced over every axis that splits it (None for any other
    leaf: its own max)."""
    axes = split_axes(sharding)
    if not axes:
        return None
    from repro_torch.models import parallel    # the models import this
    amax = x.detach().to(torch.float32).abs().max()
    for a in axes:
        amax = parallel.all_reduce(amax, a, torch.distributed.ReduceOp.MAX,
                                   mesh=sharding.mesh)
    return amax / (2.0 ** (bits - 1) - 1.0)


def compress_with_masks(params: dict, density: float, e_bits: int,
                        m_bits: int, out_dtype=None, shardings=None):
    """Prune -> fake-quant, both straight-through. Returns (cparams,
    masks): masks has a full-size 0/1 f32 leaf for compressible params
    and a scalar 1.0 for excluded ones (so the mask-aware aggregation
    broadcasts). ``out_dtype`` casts the compressed weights to the
    model's compute dtype here, numerically the cast the matmuls do
    anyway; the cast's backward returns f32 gradients. The plan is
    static, so (0, 0) bits launch nothing. ``shardings`` (name ->
    NamedSharding): on a mesh of several ranks the params are this
    rank's blocks, and a leaf split over "model" or the data axes is
    pruned (and int-k scaled) as its whole leaf; (e, m) rounding is
    elementwise, one fake_quant launch per block."""
    cparams, masks = {}, {}
    shardings = shardings or {}
    pruned = magnitude_masks({name: w.detach() for name, w in params.items()
                              if compressible(name, w)}, density,
                             shardings=shardings)
    for name, w in params.items():
        if not compressible(name, w):
            cparams[name] = w
            masks[name] = torch.ones((), dtype=torch.float32, device=w.device)
            continue
        m = pruned[name]
        scale = (_int_scale(w * m, m_bits, shardings.get(name))
                 if e_bits == 0 and m_bits > 0 else None)
        cw = fake_quant_ste(w * m, e_bits, m_bits, scale) * m
        if out_dtype is not None:
            cw = cw.to(out_dtype)
        cparams[name] = cw
        masks[name] = m.to(torch.float32)
    return cparams, masks


def compress_params(params: dict, plan: CompressionPlan, batch: int = 0):
    """Static-plan compression including clustering and structured width
    slicing. Returns (cparams, masks); differentiable through the STEs."""
    if plan.structured:
        if batch:
            raise ValueError("width slicing takes unbatched params")
        spec = submodel_spec(params, plan.width)
        csub, sub_masks = compress_params(slice_tree(params, spec),
                                          plan.inner())
        return csub, expand_masks(sub_masks, spec, params)

    e, m = plan.quant_em()
    cparams, masks = {}, {}
    pruned = magnitude_masks({name: w.detach() for name, w in params.items()
                              if compressible(name, w, batch)},
                             plan.density, batch)
    for name, w in params.items():
        if not compressible(name, w, batch):
            cparams[name] = w
            masks[name] = torch.ones((), dtype=torch.float32, device=w.device)
            continue
        mask = pruned[name]
        cw = w * mask
        if plan.cluster_k:
            cw = cluster_ste(cw, plan.cluster_k, 8, batch) * mask
        if e or m:
            cw = fake_quant_ste(cw, e, m) * mask
        cparams[name] = cw
        masks[name] = mask.to(torch.float32)
    return cparams, masks


def payload_bits(params: dict, plan: CompressionPlan) -> float:
    """Model/gradient payload size in bits under a plan (the paper's
    T_upload/T_download communication model)."""
    spec = submodel_spec(params, plan.width) if plan.structured else None
    total = 0.0
    for i, (name, leaf) in enumerate(params.items()):
        n = (math.prod(spec.local_shape(i)) if spec is not None
             else math.prod(leaf.shape))
        if compressible(name, leaf):
            total += n * plan.density * plan.bits_per_weight
            if plan.cluster_k:
                total += plan.cluster_k * 32          # codebook overhead
        else:
            total += n * 32
    return total


def active_param_count(params: dict, plan: CompressionPlan) -> float:
    """The number of parameters a device actually TRAINS under ``plan`` —
    the FLOP basis of Eq. (1)'s T_local."""
    if not plan.structured:
        return sum(math.prod(leaf.shape) for leaf in params.values()) \
            * plan.density
    spec = submodel_spec(params, plan.width)
    total = 0.0
    for i, (name, leaf) in enumerate(params.items()):
        n = math.prod(spec.local_shape(i))
        total += n * plan.density if compressible(name, leaf) else n
    return total
