"""Fake quantization with a clip-aware straight-through estimator.

Forward: exact (e,m)-format rounding or int-k. Backward: identity inside
the representable range, zero outside — the gradient the global model
receives from a quantized local model. (0, 0) bits is passthrough.

The (e,m) rounding is the fake_quant kernel (``csrc/fake_quant.cu``) on a
CUDA tensor and its plain version (``numerics.quantize_em``) on a CPU
tensor; int-k has no kernel and stays plain.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fake_quant import fake_quant
from repro_torch.numerics import max_finite, quantize_int


def _quant(x: torch.Tensor, e_bits: int, m_bits: int,
           scale=None) -> torch.Tensor:
    """Dispatch: e>0 -> (e,m) float; e==0,m>0 -> int-m (``scale``: its
    step, default the per-tensor max / qmax); e==m==0 -> passthrough."""
    if e_bits > 0:
        return fake_quant(x, e_bits, m_bits)
    if m_bits > 0:
        return quantize_int(x, m_bits, scale=scale)
    return x


class FakeQuantSTE(torch.autograd.Function):
    @staticmethod
    def forward(x, e_bits, m_bits, scale=None):
        return _quant(x, e_bits, m_bits, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, e_bits, m_bits = inputs[:3]
        if e_bits > 0:
            ctx.save_for_backward(x.abs() <= max_finite(e_bits, m_bits))
        else:
            ctx.save_for_backward(None)

    @staticmethod
    def backward(ctx, g):
        (in_range,) = ctx.saved_tensors
        if in_range is not None:
            g = torch.where(in_range, g, torch.zeros_like(g))
        return g, None, None, None


def fake_quant_ste(x: torch.Tensor, e_bits: int, m_bits: int,
                   scale=None) -> torch.Tensor:
    """``scale``: int-k's step in place of ``x``'s own max / qmax (a leaf
    split over ranks takes the whole leaf's)."""
    return FakeQuantSTE.apply(x, e_bits, m_bits, scale)
