"""Public wrapper of the flash_attention CUDA kernels
(``csrc/flash_attention.cu``): (B, T, H, hd) attention with GQA, causal,
sliding-window and ``q_offset`` masks. A CUDA tensor launches a kernel
or raises; a CPU tensor takes the plain version in ``ref.py``.

Where a CUDA call goes (:func:`route`): bf16 with hd 64 or 128 that TMA
can read takes the tensor-core kernel (``"wgmma"``), everything else the
CUDA-core kernel (``"simt"``). Neither falls back to the other or to the
plain version. ``flash_attention.launches`` counts kernel launches,
``flash_attention.route_launches`` the same per route.

``FlashAttention`` is the differentiable form: its forward is the kernel
and its backward recomputes the plain version and returns that VJP, as
the reference's custom VJP does (a backward kernel is later work).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HD_MAX = 128
WGMMA_HD = (64, 128)            # head widths the wgmma kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ENCODE_FAILED, _NO_ENCODER, _FEW_REGISTERS = 100000, 200000, 300000


@functools.lru_cache(maxsize=None)
def _launcher(route: str):
    """The route's C entry point, built and bound once."""
    lib = load("flash_attention")
    if route == "wgmma":
        fn = lib.flash_attention_wgmma_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p]
    else:
        fn = lib.flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
            ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel for ``flash_attention(q, k, v)``: ``"wgmma"`` for bf16
    q, k, v with hd 64 or 128, contiguous with bases aligned to 16 bytes
    (TMA's rule; contiguous rows of 64 or 128 bf16 keep every stride a
    multiple of 16 bytes), B * H <= 65535 and no empty dimension;
    ``"simt"`` for everything else."""
    ops = (q, k, v)
    if (any(t.dtype != torch.bfloat16 or t.dim() != 4 or 0 in t.shape
            or not t.is_contiguous() or t.data_ptr() % 16 for t in ops)
            or q.shape[-1] not in WGMMA_HD
            or q.shape[0] * q.shape[2] > 65535):
        return "simt"
    return "wgmma"


def _error(rc: int) -> str:
    if rc >= _FEW_REGISTERS:
        return (f"the wgmma kernel was compiled to {rc - _FEW_REGISTERS} "
                f"registers a thread, below the 168 its setmaxnreg needs")
    if rc == _NO_ENCODER:
        return "cuTensorMapEncodeTiled not found in libcuda"
    if rc >= _ENCODE_FAILED:
        return f"cuTensorMapEncodeTiled failed: CUresult {rc - _ENCODE_FAILED}"
    return f"cudaError {rc}"


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            causal: bool = True, window: int = 0,
                            q_offset: int = 0) -> torch.Tensor:
    """The forward alone, no autograd: q (B, T, H, hd); k, v
    (B, S, Hkv, hd) -> (B, T, H, hd) in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B,T,H,hd) and k, v "
                         f"(B,S,Hkv,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or h % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
    devs = {q.device, k.device, v.device}
    if devs == {torch.device("cpu")}:
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CPU or CUDA tensors on one "
                         f"device, got {sorted(map(str, devs))}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")
    if hd > HD_MAX:
        raise ValueError(f"flash_attention takes head_dim <= {HD_MAX}, "
                         f"got {hd}")
    out = torch.empty_like(q)
    r = route(q, k, v)
    fn = _launcher(r)
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if r == "simt":
        head.append(_DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        rc = fn(*head, b, t, s, h, hkv, hd, int(causal), int(window),
                int(q_offset), 1.0 / math.sqrt(hd),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention {r} kernel launch failed: "
                           f"{_error(rc)}")
    flash_attention.launches += 1
    flash_attention.route_launches[r] += 1
    return out


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, causal, window, q_offset):
        return flash_attention_forward(q, k, v, causal, window, q_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, q_offset = inputs
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
            o = flash_attention_ref(q, k, v, **ctx.opts)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Tq, H, hd); k, v: (B, S, Hkv, hd) -> (B, Tq, H, hd),
    differentiable."""
    return FlashAttention.apply(q, k, v, causal, window, q_offset)


flash_attention.launches = 0
flash_attention.route_launches = {"wgmma": 0, "simt": 0}
