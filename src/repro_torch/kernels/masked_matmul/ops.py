"""Public wrapper of the masked_matmul CUDA kernel
(``csrc/masked_matmul.cu``): ``y = x @ (w * mask)`` with f32
accumulation, differentiable. The backward runs the same kernel twice,
``dx = g @ (w*mask)^T`` and ``dw = (x^T @ g) * mask`` (exactly 0 where
the mask is 0), and gives the mask no gradient, as the reference's
custom VJP does. Transposed operands are read in place through their
strides, never copied. A CUDA tensor launches the kernel or raises; a
CPU tensor takes the plain version in ``ref.py``. There is no fallback
from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib):
    fn = lib.masked_matmul_launch
    fn.argtypes = ([ctypes.c_int]
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 4
                   + [ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def unit_strided(t: torch.Tensor) -> bool:
    """A 2-D tensor the kernels read in place: row- or column-major (a
    contiguous matrix or its transpose)."""
    return t.dim() == 2 and (t.stride(1) == 1 or t.stride(0) == 1
                             or min(t.shape) <= 1)


def _operand(t: torch.Tensor | None):
    if t is None:
        return [None, 0, 0]
    return [t.data_ptr(), t.stride(0), t.stride(1)]


def _launch(a: torch.Tensor, b: torch.Tensor, b_mask: torch.Tensor | None,
            out_mask: torch.Tensor | None) -> torch.Tensor:
    """``(a @ (b * b_mask)) * out_mask`` on the card, (M, N) row-major in
    a's dtype; masks may be None."""
    m, k = a.shape
    n = b.shape[1]
    for t in (b, b_mask, out_mask):
        if t is not None and not unit_strided(t):
            raise ValueError("masked_matmul takes row- or column-major "
                             "2-D operands")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    fn = _bind(load("masked_matmul"))
    with torch.cuda.device(a.device):
        rc = fn(_DTYPES[a.dtype], *_operand(a), *_operand(b),
                *_operand(b_mask), *_operand(out_mask), out.data_ptr(), m, n,
                k, torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"masked_matmul kernel launch failed: "
                           f"cudaError {rc}")
    masked_matmul.launches += 1
    return out


class MaskedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(x, w, mask):
        return _launch(x, w, mask, None)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, w, mask = ctx.saved_tensors
        if not unit_strided(g):
            g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _launch(g, w.t(), mask.t(), None)
        if ctx.needs_input_grad[1]:
            dw = _launch(x.t(), g, None, mask)
        return dx, dw, None


def masked_matmul(x: torch.Tensor, w: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """y = x @ (w * mask); x: (M, K), w and mask: (K, N) of x's dtype
    (f32 or bf16 on the card), each row- or column-major. Returns (M, N)
    in x's dtype, differentiable in x and w."""
    if x.dim() != 2 or w.dim() != 2 or mask.shape != w.shape \
            or x.shape[1] != w.shape[0]:
        raise ValueError(f"masked_matmul takes x (M, K) and w, mask (K, N), "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(mask.shape)}")
    devs = {x.device, w.device, mask.device}
    if devs == {torch.device("cpu")}:
        return masked_matmul_ref(x, w, mask)
    if len(devs) != 1 or x.device.type != "cuda":
        raise ValueError(f"masked_matmul takes CPU or CUDA tensors on one "
                         f"device, got {sorted(map(str, devs))}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype or mask.dtype != x.dtype:
        raise TypeError(f"masked_matmul takes float32 or bfloat16 x, w, mask "
                        f"of one dtype, got {x.dtype}/{w.dtype}/{mask.dtype}")
    if not unit_strided(x):
        raise ValueError("masked_matmul takes row- or column-major 2-D "
                         "operands")
    return MaskedMatmul.apply(x, w, mask)


masked_matmul.launches = 0
