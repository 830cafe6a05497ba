"""Public wrappers of the structured_scatter CUDA kernel
(``csrc/structured_scatter.cu``): coverage-counted aggregation of
per-tier width-sliced uploads into one leaf, or into L same-signature
leaves in one launch. A CUDA tensor launches the kernel or raises; a CPU
tensor takes the plain version in ``ref.py``. There is no fallback from
one to the other."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.grad_aggregate.ops import host_weights
from repro_torch.kernels.structured_scatter.ref import (leaf_views,
                                                        scatter_views_ref)

MAX_TIERS = 8


def _bind(lib):
    fn = lib.structured_scatter_launch
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_float),
                   ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _scatter(g3s, m3s, scalar, wn, wd, lrc, eps) -> torch.Tensor:
    dev = g3s[0].device
    if all(x.device.type == "cpu" for x in g3s + m3s):
        return scatter_views_ref(g3s, m3s, scalar, wn, wd, lrc, eps)
    if dev.type != "cuda" or any(x.device != dev for x in g3s + m3s):
        raise ValueError("structured_scatter takes CPU or CUDA tensors on "
                         "one device")
    if any(x.dtype != torch.float32 for x in g3s + m3s):
        raise TypeError("structured_scatter takes float32 tensors")
    t = len(g3s)
    if not 1 <= t <= MAX_TIERS:
        raise ValueError(f"structured_scatter takes 1..{MAX_TIERS} tiers, "
                         f"got {t}")
    L, R, C = lrc
    for g in g3s:
        if g.shape[0] != L or g.shape[1] > R or g.shape[2] > C:
            raise ValueError(f"tier view {tuple(g.shape)} is not a prefix "
                             f"block of {lrc}")
    out = torch.empty(lrc, dtype=torch.float32, device=dev)
    fn = _bind(load("structured_scatter"))
    with torch.cuda.device(dev):
        rc = fn((ctypes.c_void_p * t)(*[g.data_ptr() for g in g3s]),
                (ctypes.c_void_p * t)(*[m.data_ptr() for m in m3s]),
                (ctypes.c_int * t)(*[g.shape[1] for g in g3s]),
                (ctypes.c_int * t)(*[g.shape[2] for g in g3s]),
                (ctypes.c_int * t)(*[int(s) for s in scalar]),
                (ctypes.c_float * t)(*wn), (ctypes.c_float * t)(*wd),
                t, L, R, C, eps, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"structured_scatter kernel launch failed: "
                           f"cudaError {rc}")
    structured_scatter.launches += 1
    return out


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
    """:func:`structured_scatter` over L same-signature leaves in ONE
    launch: ``gs[t]``/``ms[t]`` are stacked ``(L, *local_t)`` (masks may
    be ``(L,)`` scalars-per-leaf); ``out_shape`` is the single-leaf
    global shape; returns ``(L, *out_shape)``."""
    t = len(gs)
    wn = host_weights(w, t)
    wd = wn if w_den is None else host_weights(w_den, t)
    g3s, m3s, scalar, lrc = leaf_views(gs, ms, tuple(out_shape))
    out = _scatter(g3s, m3s, scalar, wn, wd, lrc, eps)
    return out.reshape((lrc[0],) + tuple(out_shape))


structured_scatter.launches = 0
