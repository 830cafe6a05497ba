"""Public wrapper of the masked_matmul CUDA kernels
(``csrc/masked_matmul.cu``): ``y = x @ (w * mask)`` with f32
accumulation, differentiable. The backward runs the kernels twice,
``dx = g @ (w*mask)^T`` and ``dw = (x^T @ g) * mask`` (exactly 0 where
the mask is 0), and gives the mask no gradient, as the reference's
custom VJP does. Transposed operands are read in place through their
strides, never copied.

Where a call goes (:func:`backend`, :func:`route`): CPU tensors take the
plain version in ``ref.py``; CUDA tensors launch a kernel or raise. A
bf16 call whose operands TMA can describe takes the tensor-core kernel
(``"wgmma"``), every other CUDA call the CUDA-core kernel (``"simt"``).
Neither falls back to the other or to the plain version.
``masked_matmul.launches`` counts kernel launches,
``masked_matmul.route_launches`` the same per route.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"simt": 0, "wgmma": 1}
WG_BM, WG_BK = 128, 64          # the wgmma kernel's row tile and K step
_ENCODE_FAILED, _NO_ENCODER = 100000, 200000


@functools.lru_cache(maxsize=None)
def _launcher():
    """The kernels' C entry point, built and bound once."""
    fn = load("masked_matmul").masked_matmul_launch
    fn.argtypes = ([ctypes.c_int] * 2
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 4
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def unit_strided(t: torch.Tensor) -> bool:
    """A 2-D tensor the kernels read in place: row- or column-major (a
    contiguous matrix or its transpose)."""
    return t.dim() == 2 and (t.stride(1) == 1 or t.stride(0) == 1
                             or min(t.shape) <= 1)


def as_unit_strided(t: torch.Tensor) -> torch.Tensor:
    """``t`` with one stride 1, as the kernels index it: a unit-strided
    matrix as it is, a vector with other strides copied (a few bytes)."""
    return t if t.stride(1) == 1 or t.stride(0) == 1 else t.contiguous()


def backend(devices) -> str:
    """``"plain"`` when every tensor lies on the CPU, ``"kernel"`` when
    all lie on one CUDA device; raises otherwise."""
    devs = set(devices)
    if devs == {torch.device("cpu")}:
        return "plain"
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"masked_matmul takes CPU or CUDA tensors on one "
                         f"device, got {sorted(map(str, devs))}")
    return "kernel"


def tma_ok(t: torch.Tensor) -> bool:
    """Whether TMA can read the 2-D tensor ``t``: a base aligned to 16
    bytes, one unit stride, and the other positive and a multiple of 16
    bytes."""
    if t.dim() != 2:
        return False
    s0, s1 = t.stride()
    ld = s0 if s1 == 1 else s1 if s0 == 1 else 0
    return (ld > 1 and ld * t.element_size() % 16 == 0
            and t.data_ptr() % 16 == 0)


def route(a: torch.Tensor, b: torch.Tensor,
          b_mask: torch.Tensor | None = None) -> str:
    """The kernel for ``(a @ (b * b_mask))``: ``"wgmma"`` for bf16
    operands that TMA can describe (:func:`tma_ok`), b_mask laid out as
    b, no empty dimension; ``"simt"`` for everything else (f32, or bf16
    with a stride or base TMA refuses)."""
    ops = [t for t in (a, b, b_mask) if t is not None]
    if (a.dtype != torch.bfloat16 or 0 in a.shape or 0 in b.shape
            or (b_mask is not None and b_mask.stride() != b.stride())):
        return "simt"
    return "wgmma" if all(tma_ok(t) for t in ops) else "simt"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wgmma_plan(m: int, n: int, k: int, sms: int) -> tuple[int, int]:
    """(column tile, K splits) of the wgmma kernel for an (m, k) @ (k, n)
    product on ``sms`` SMs: 128 x 128 tiles where they fill the SMs,
    else 128 x 64, and then K split in 2, 4, ... (each split keeping at
    least 4 K steps of 64) until the tiles do."""
    if _cdiv(m, WG_BM) * _cdiv(n, 128) >= sms:
        return 128, 1
    tiles, kb, splits = _cdiv(m, WG_BM) * _cdiv(n, 64), _cdiv(k, WG_BK), 1
    while tiles * splits < sms and kb >= 8 * splits:
        splits *= 2
    return 64, splits


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _operand(t: torch.Tensor | None):
    if t is None:
        return [None, 0, 0]
    return [t.data_ptr(), t.stride(0), t.stride(1)]


def launch_error(rc: int) -> str:
    if rc == _NO_ENCODER:
        return "cuTensorMapEncodeTiled not found in libcuda"
    if rc >= _ENCODE_FAILED:
        return f"cuTensorMapEncodeTiled failed: CUresult {rc - _ENCODE_FAILED}"
    return f"cudaError {rc}"


def masked_product(a: torch.Tensor, b: torch.Tensor,
                   b_mask: torch.Tensor | None = None,
                   out_mask: torch.Tensor | None = None) -> torch.Tensor:
    """One kernel launch on the card: ``(a @ (b * b_mask)) * out_mask``,
    (M, N) row-major in a's dtype, with b * b_mask formed in the dtype
    and out_mask applied to the result rounded to it; masks may be None.
    The forward and both gradients of :func:`masked_matmul` are such
    launches."""
    for t in (b, b_mask, out_mask):
        if t is not None and not unit_strided(t):
            raise ValueError("masked_matmul takes row- or column-major "
                             "2-D operands")
    a, b = as_unit_strided(a), as_unit_strided(b)
    if b_mask is not None:
        b_mask = as_unit_strided(b_mask)
    m, k = a.shape
    n = b.shape[1]
    r = route(a, b, b_mask)
    bn, splits, ws = WG_BM, 1, None
    if r == "wgmma":
        index = a.device.index
        bn, splits = wgmma_plan(m, n, k, sm_count(
            torch.cuda.current_device() if index is None else index))
        if splits > 1:
            ws = torch.empty((splits, m, n), dtype=torch.float32,
                             device=a.device)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    fn = _launcher()
    with torch.cuda.device(a.device):
        rc = fn(_DTYPES[a.dtype], ROUTES[r], *_operand(a), *_operand(b),
                *_operand(b_mask), *_operand(out_mask), out.data_ptr(),
                None if ws is None else ws.data_ptr(), m, n, k, bn, splits,
                torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"masked_matmul {r} kernel launch failed: "
                           f"{launch_error(rc)}")
    masked_matmul.launches += 1
    masked_matmul.route_launches[r] += 1
    return out


class MaskedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(x, w, mask):
        return masked_product(x, w, mask)

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
            dx = masked_product(g, w.t(), mask.t())
        if ctx.needs_input_grad[1]:
            dw = masked_product(x.t(), g, out_mask=mask)
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
    if backend((x.device, w.device, mask.device)) == "plain":
        return masked_matmul_ref(x, w, mask)
    if x.dtype not in _DTYPES or w.dtype != x.dtype or mask.dtype != x.dtype:
        raise TypeError(f"masked_matmul takes float32 or bfloat16 x, w, mask "
                        f"of one dtype, got {x.dtype}/{w.dtype}/{mask.dtype}")
    if not unit_strided(x):
        raise ValueError("masked_matmul takes row- or column-major 2-D "
                         "operands")
    return MaskedMatmul.apply(x, w, mask)


masked_matmul.launches = 0
masked_matmul.route_launches = {r: 0 for r in ROUTES}
