"""Public wrapper of the fake_quant CUDA kernel (``csrc/fake_quant.cu``):
round a tensor onto the (1, e, m) float grid, forward only (the
clip-aware straight-through gradient is
``core/compression/quantization.py``'s ``FakeQuantSTE``). A CUDA tensor
launches the kernel or raises; a CPU tensor takes the plain version in
``ref.py``. There is no fallback from one to the other."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.fake_quant.ref import fake_quant_ref
from repro_torch.numerics.float_formats import _fmt_consts


def _bind(lib):
    fn = lib.fake_quant_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fake_quant(x: torch.Tensor, e_bits: int, m_bits: int) -> torch.Tensor:
    """``quantize_em(x, e_bits, m_bits)`` for any shape; e_bits > 0.
    On the card the kernel reads and writes f32: another dtype is cast to
    f32 and back, and a non-contiguous tensor is copied to a contiguous
    one, explicitly, before the launch."""
    if e_bits <= 0:
        raise ValueError(f"fake_quant takes a float format (e_bits > 0), "
                         f"got e_bits={e_bits}")
    if x.device.type == "cpu":
        return fake_quant_ref(x, e_bits, m_bits)
    if x.device.type != "cuda":
        raise ValueError(f"fake_quant takes CPU or CUDA tensors, got {x.device}")
    if not x.is_floating_point():
        raise TypeError(f"fake_quant takes a floating tensor, got {x.dtype}")
    xf = x.to(torch.float32).contiguous()
    out = torch.empty_like(xf)
    emin, maxv = _fmt_consts(e_bits, m_bits)
    fn = _bind(load("fake_quant"))
    with torch.cuda.device(x.device):
        rc = fn(xf.data_ptr(), out.data_ptr(), xf.numel(), emin, m_bits,
                maxv, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fake_quant kernel launch failed: cudaError {rc}")
    fake_quant.launches += 1
    return out.to(x.dtype)


fake_quant.launches = 0
