"""Plain PyTorch version of the fake_quant kernel: the port's
``quantize_em``, the function the CUDA kernel must equal bit for bit."""
from __future__ import annotations

import torch

from repro_torch.numerics import quantize_em


def fake_quant_ref(x: torch.Tensor, e_bits: int, m_bits: int) -> torch.Tensor:
    return quantize_em(x, e_bits, m_bits)
