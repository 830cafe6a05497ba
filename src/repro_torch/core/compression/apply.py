"""Apply a compression plan to a whole parameter dict.

Only matrix-shaped leaves (``compressible``) are compressed; 1-D leaves
and the MoE router stay full precision. For STRUCTURED plans the
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
from repro_torch.core.compression.pruning import magnitude_mask
from repro_torch.core.compression.quantization import fake_quant_ste
from repro_torch.core.compression.structured import (compressible,
                                                     expand_masks, slice_tree,
                                                     submodel_spec)

__all__ = ["compressible", "compress_params", "payload_bits",
           "active_param_count"]


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
    for name, w in params.items():
        if not compressible(name, w, batch):
            cparams[name] = w
            masks[name] = torch.ones((), dtype=torch.float32, device=w.device)
            continue
        mask = magnitude_mask(w.detach(), plan.density, batch)
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
