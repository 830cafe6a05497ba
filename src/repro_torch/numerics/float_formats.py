"""Arbitrary-bit-width floating-point simulation (paper §7.1), in PyTorch.

Values are rounded (round-to-nearest-even) onto the exact representable
set of a (1, e, m) format — normals, subnormals, and saturation to the
max finite value (no inf/nan encodings) — while storage stays f32. The
arithmetic is f32 throughout, as in the JAX reference, and every power
of two is built from its bit pattern, so the constants are exact on the
CPU and on the GPU alike (``pow``/``exp2`` are not bit-exact everywhere).

The formats here are static per plan, so ``e_bits``/``m_bits`` are
Python ints.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class FloatFormat:
    name: str
    e_bits: int
    m_bits: int

    @property
    def bits(self) -> int:
        return 1 + self.e_bits + self.m_bits


FORMATS: dict[str, FloatFormat] = {f.name: f for f in [
    FloatFormat("fp32", 8, 23),         # passthrough under f32 storage
    FloatFormat("bf16", 8, 7),
    FloatFormat("fp16", 5, 10),
    FloatFormat("fp8_e4m3", 4, 3),
    FloatFormat("fp8_e5m2", 5, 2),
    FloatFormat("fp6_e3m2", 3, 2),
    FloatFormat("fp4_e2m1", 2, 1),
]}


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact f32 ``2**e`` for an integer tensor ``e``, from bit patterns:
    normals for e in [-126, 127], the subnormal grid down to 2**-149, and
    0 below it."""
    e = e.to(torch.int32)
    normal = ((e.clamp(-126, 127) + 127) << 23).view(torch.float32)
    sub = (torch.ones_like(e) << (e.clamp(-149, -127) + 149)).view(torch.float32)
    zero = torch.zeros_like(normal)
    return torch.where(e >= -126, normal, torch.where(e >= -149, sub, zero))


def _fmt_consts(e_bits: int, m_bits: int) -> tuple[int, float]:
    """(emin, maxv): min normal exponent and max finite value
    (2**emax * (2 - 2**-m), exact in f32). For the e=8 formats that value
    overflows f32, and the f32 reference arithmetic makes it inf."""
    bias = 2 ** (e_bits - 1) - 1
    emin = 1 - bias
    emax = 2 ** e_bits - 1 - bias                   # no inf/nan reserved
    if emax > 127:
        return emin, float("inf")
    return emin, 2.0 ** emax * (2.0 - 2.0 ** -m_bits)


def max_finite(e_bits: int, m_bits: int) -> float:
    return _fmt_consts(e_bits, m_bits)[1]


def quantize_em(x: torch.Tensor, e_bits: int, m_bits: int) -> torch.Tensor:
    """Round x (f32) to the representable set of the (1, e, m) float format.

    Round-to-nearest-even; saturating; exact subnormal grid below emin.
    """
    dt = x.dtype
    x = x.to(torch.float32)
    emin, maxv = _fmt_consts(e_bits, m_bits)
    xc = torch.clamp(x, -maxv, maxv)
    # exact exponent via frexp (|xc| = mant * 2^e2, mant in [0.5, 1)),
    # floored at emin => exact subnormal grid below emin
    _, e2 = torch.frexp(xc.abs())
    ex = torch.clamp_min(e2.to(torch.int32) - 1, emin)
    quantum = pow2(ex - m_bits)
    q = torch.round(xc / quantum) * quantum             # round is RNE
    return torch.where(torch.isfinite(x), q, x).to(dt)


def quantize_int(x: torch.Tensor, bits: int, *, scale=None) -> torch.Tensor:
    """Symmetric per-tensor int-k fake quantization; ``scale`` (a number
    or a tensor) replaces the per-tensor max / qmax, floored at 1e-12
    like it."""
    dt = x.dtype
    x = x.to(torch.float32)
    qmax = 2.0 ** (bits - 1) - 1.0
    if scale is None:
        scale = x.abs().max() / qmax
    scale = torch.clamp_min(torch.as_tensor(scale, dtype=torch.float32,
                                            device=x.device), 1e-12)
    return (torch.clamp(torch.round(x / scale), -qmax, qmax) * scale).to(dt)
