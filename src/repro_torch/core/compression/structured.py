"""Structured sub-model compression: width-sliced local models,
HeteroFL-style (Diao et al., 2021).

Every compressible matrix leaf ``(d_in, ..., d_out)`` becomes the dense
PREFIX slice ``(ceil(w*d_in), ..., ceil(w*d_out))`` on its first and last
axes; the model's input dim (axis 0 of the first matrix leaf) and output
dim (last axis of the last matrix leaf) are preserved; a 1-D leaf beside
a sliced matrix leaf whose out-dim it matches (the ``{"w", "b"}`` layer)
is co-sliced to the matrix's out-slice. Leaves are named by dotted paths
(``layers.0.w``) and taken in the dict's order — the reference's flatten
order — so ``SubmodelSpec.slices[i]`` names the same leaf in both
packages.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

_EXCLUDE = ("router",)


def compressible(name: str, leaf, batch: int = 0) -> bool:
    """Matrix-shaped (ndim >= 2, not counting ``batch`` leading axes)
    leaves compress; 1-D leaves and the MoE router stay full precision /
    full shape."""
    if any(x in name for x in _EXCLUDE):
        return False
    return len(leaf.shape) - batch >= 2


def _ceil_dim(width: float, d: int) -> int:
    return min(d, max(1, math.ceil(width * d)))


def _parent(name: str) -> str:
    return name.rsplit(".", 1)[0] if "." in name else ""


@dataclass(frozen=True)
class SubmodelSpec:
    """Static slice plan for one (param dict, width) pair: ``slices[i]``
    is leaf i's LOCAL shape when sliced, else ``None``; ``shapes[i]`` its
    global shape."""
    width: float
    slices: tuple
    shapes: tuple

    @property
    def is_identity(self) -> bool:
        return all(s is None for s in self.slices)

    def local_shape(self, i: int) -> tuple:
        return self.slices[i] if self.slices[i] is not None else self.shapes[i]

    def local_size(self) -> int:
        return sum(math.prod(self.local_shape(i))
                   for i in range(len(self.shapes)))


def submodel_spec(params: dict, width: float) -> SubmodelSpec:
    """The slice plan for ``params`` at ``width`` (shapes only)."""
    names = list(params)
    shapes = tuple(tuple(params[k].shape) for k in names)
    slices: list = [None] * len(names)
    mat = [i for i, k in enumerate(names) if compressible(k, params[k])]
    if mat:
        first, last = mat[0], mat[-1]
        out_by_parent: dict = {}
        for i in mat:
            shape = shapes[i]
            rows = shape[0] if i == first else _ceil_dim(width, shape[0])
            cols = shape[-1] if i == last else _ceil_dim(width, shape[-1])
            loc = (rows,) + shape[1:-1] + (cols,)
            if loc != shape:
                slices[i] = loc
            out_by_parent.setdefault(_parent(names[i]), (cols, shape[-1]))
        if width < 1.0 and len(mat) == 1:
            raise ValueError(
                "width slicing needs an interior dimension to cut: this "
                "model's only matrix leaf carries the model input AND "
                "output dims, which are preserved. Use a masked plan "
                "(density) for single-matrix models.")
        for i, k in enumerate(names):
            if i in mat or len(shapes[i]) != 1:
                continue
            oc = out_by_parent.get(_parent(k))
            if oc is not None and shapes[i][0] == oc[1] and oc[0] != oc[1]:
                slices[i] = (oc[0],)
    return SubmodelSpec(width=width, slices=tuple(slices), shapes=shapes)


def slice_tree(params: dict, spec: SubmodelSpec) -> dict:
    """Cut the dense sub-model out of ``params``; unsliced leaves are
    returned as they are (the same tensors)."""
    return {k: v if s is None else v[tuple(slice(0, n) for n in s)]
            for (k, v), s in zip(params.items(), spec.slices)}


def slice_submodel(params: dict, width: float):
    """``(sub_params, spec)``: the dense width-``width`` sub-model and the
    slice plan that scatters updates back."""
    spec = submodel_spec(params, width)
    return slice_tree(params, spec), spec


def _pad_to(x: torch.Tensor, full: tuple, local: tuple) -> torch.Tensor:
    pad = []
    for f, k in reversed(list(zip(full, local))):
        pad += [0, f - k]
    return F.pad(x, pad)


def expand_update(sub_grads: dict, spec: SubmodelSpec, global_params: dict):
    """Zero-pad sub-model updates back to global shapes (the transpose of
    :func:`slice_tree`)."""
    return {k: g if s is None else _pad_to(g, tuple(global_params[k].shape), s)
            for (k, g), s in zip(sub_grads.items(), spec.slices)}


def expand_masks(sub_masks: dict, spec: SubmodelSpec, global_params: dict):
    """Lift local masks to GLOBAL shapes: array masks on sliced leaves are
    zero-padded, scalar masks on sliced leaves become prefix coverage
    vectors, pass-through leaves keep their mask."""
    out = {}
    for (k, m), s in zip(sub_masks.items(), spec.slices):
        full = tuple(global_params[k].shape)
        if s is None:
            out[k] = m
        elif m.dim() == len(s):
            out[k] = _pad_to(m, full, s)
        else:                       # scalar mask on a co-sliced 1-D leaf
            cov = torch.full(s, 0.0, dtype=torch.float32, device=m.device) + m
            out[k] = _pad_to(cov, full, s)
    return out
