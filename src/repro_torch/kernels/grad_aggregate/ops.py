"""Public wrapper of the grad_aggregate CUDA kernel
(``csrc/grad_aggregate.cu``): mask-aware aggregation of a stack of
per-tier updates of one leaf. A CUDA tensor launches the kernel or
raises; a CPU tensor takes the plain version in ``ref.py``. There is no
fallback from one to the other."""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.grad_aggregate.ref import grad_aggregate_ref

MAX_TIERS = 8


def host_weights(w, t: int) -> list[float]:
    """T weights as Python floats holding f32 values (a CUDA tensor is
    read back to the host)."""
    if isinstance(w, torch.Tensor):
        w = w.detach().to("cpu", torch.float32).reshape(-1).tolist()
    w = [float(np.float32(x)) for x in np.asarray(w, np.float64).reshape(-1)]
    if len(w) != t:
        raise ValueError(f"{len(w)} weights for {t} tiers")
    return w


def _bind(lib):
    fn = lib.grad_aggregate_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.POINTER(ctypes.c_float),
                   ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def grad_aggregate(g: torch.Tensor, m: torch.Tensor, w, eps: float = 1e-8,
                   *, w_den=None) -> torch.Tensor:
    """g: (T, ...) stacked tier updates; m: the same shape, or (T,) /
    (T, 1) one scalar mask per tier; w, w_den: (T,) numerator and
    denominator weights (``w_den`` defaults to ``w``). Returns (...)."""
    t = g.shape[0]
    shape = tuple(g.shape[1:])
    n = math.prod(shape)
    g2 = g.reshape(t, n)
    m2 = m.reshape(t, -1)
    if m2.shape[1] not in (1, n):
        raise ValueError(f"mask shape {tuple(m.shape)} does not match "
                         f"updates {tuple(g.shape)}")
    wn = host_weights(w, t)
    wd = wn if w_den is None else host_weights(w_den, t)
    if g.device.type == "cpu" and m.device.type == "cpu":
        return grad_aggregate_ref(g2, m2, wn, wd, eps).reshape(shape)
    if g.device.type != "cuda" or m.device != g.device:
        raise ValueError(f"grad_aggregate takes CPU or CUDA tensors on one "
                         f"device, got {g.device} and {m.device}")
    if g.dtype != torch.float32 or m.dtype != torch.float32:
        raise TypeError(f"grad_aggregate takes float32, got {g.dtype}/{m.dtype}")
    if not (g2.is_contiguous() and m2.is_contiguous()):
        raise ValueError("grad_aggregate takes contiguous tensors")
    if not 1 <= t <= MAX_TIERS:
        raise ValueError(f"grad_aggregate takes 1..{MAX_TIERS} tiers, got {t}")
    out = torch.empty(n, dtype=torch.float32, device=g.device)
    fn = _bind(load("grad_aggregate"))
    full = m2.shape[1] == n
    with torch.cuda.device(g.device):
        rc = fn(g2.data_ptr(), m2.data_ptr(), n if full else 1,
                1 if full else 0, (ctypes.c_float * t)(*wn),
                (ctypes.c_float * t)(*wd), t, n, eps, out.data_ptr(),
                torch.cuda.current_stream(g.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grad_aggregate kernel launch failed: "
                           f"cudaError {rc}")
    grad_aggregate.launches += 1
    return out.reshape(shape)


grad_aggregate.launches = 0
