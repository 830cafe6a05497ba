"""Plain PyTorch version of the flash_attention kernel: the reference's
oracle (materialized softmax, f32), ``kernels/flash_attention/ref.py``
there. Its VJP is also the backward of the port's ``FlashAttention``."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """q: (B, Tq, H, hd); k, v: (B, S, Hkv, hd) -> (B, Tq, H, hd) in
    q's dtype. A fully masked row is exactly 0."""
    b, tq, h, hd = q.shape
    s = k.shape[1]
    n_rep = h // k.shape[2]
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(hd)
    qpos = q_offset + torch.arange(tq, device=q.device)
    kpos = torch.arange(s, device=q.device)
    mask = torch.ones((tq, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    return torch.einsum("bhqk,bkhd->bqhd", p,
                        v.to(torch.float32)).to(q.dtype)
