"""Plain PyTorch version of the codebook_matmul kernels, the reference's
oracle (``codebook_matmul_ref``): decode ``codebook[idx]`` and take the
f32 product, cast to x's dtype.

Indices are meant to lie in [0, n_codes). One outside follows the
oracle's JAX gather, not the TPU kernel (which gives 0.0): a negative
index counts from the end, then the result is clamped into range.

Beside it, for the tests, the wgmma route's arithmetic in plain f32
(:func:`split_terms`, :func:`wgmma_emulation`)."""
from __future__ import annotations

import torch

TOP16 = -65536                  # 0xFFFF0000 as an int32: a bf16's bits


def decode(idx: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """``codebook[idx]`` in f32 with the JAX gather's index rules."""
    n = codebook.shape[0]
    i = idx.to(torch.int64)
    i = torch.where(i < 0, i + n, i).clamp(0, n - 1)
    return codebook.to(torch.float32)[i]


def codebook_matmul_ref(x: torch.Tensor, idx: torch.Tensor,
                        codebook: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.float32) @ decode(idx, codebook)).to(x.dtype)


def split_terms(v: torch.Tensor) -> list[torch.Tensor]:
    """f32 ``v`` as the wgmma route's three bf16 terms (held in f32), v =
    t1 + t2 + t3, each the bf16 of what is left (rounded to nearest even;
    both differences are exact in f32), except that t1 is truncated where
    rounding would give inf (|v| >= 0x7F7F8000 as bits). A non-finite v
    is t1 alone."""
    v = v.to(torch.float32)

    def bf16(t):
        return t.to(torch.bfloat16).float()
    bits = v.view(torch.int32) & 0x7FFFFFFF
    top = (v.view(torch.int32) & TOP16).view(torch.float32)
    t1 = torch.where(bits >= 0x7F7F8000, top, bf16(v))
    r1 = torch.where(torch.isfinite(v), v - t1, 0.0)
    t2 = bf16(r1)
    return [t1, t2, bf16(r1 - t2)]


def wgmma_emulation(x: torch.Tensor, idx: torch.Tensor,
                    codebook: torch.Tensor) -> torch.Tensor:
    """The wgmma route's arithmetic in plain f32: for each 16-deep K
    step, the products x_a @ c_b in the kernel's order (bf16 x: x c1,
    x c2, x c3; f32 x split as the codewords are: x1 c1, x1 c2, x1 c3,
    x2 c1, x2 c2, x3 c1) added to one f32 accumulator, then cast to x's
    dtype."""
    w = split_terms(decode(idx, codebook))
    xs = ([x.float()] if x.dtype == torch.bfloat16
          else split_terms(x.float()))
    acc = torch.zeros((x.shape[0], w[0].shape[1]), dtype=torch.float32)
    for k0 in range(0, x.shape[1], 16):
        for a, xa in enumerate(xs):
            for wb in w[:3 - a]:
                acc += xa[:, k0:k0 + 16] @ wb[k0:k0 + 16]
    return acc.to(x.dtype)
