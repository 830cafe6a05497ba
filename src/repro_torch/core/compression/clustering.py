"""Weight clustering: per-tensor k-means codebook (quantile init, then
Lloyd iterations on a strided subsample) + straight-through
reconstruction. Leading ``batch`` axes hold independent tensors, each
with its own codebook."""
from __future__ import annotations

import torch

SAMPLE = 1 << 14


@torch.no_grad()
def kmeans_codebook(w: torch.Tensor, k: int, iters: int = 8,
                    batch: int = 0) -> torch.Tensor:
    """(*batch, k) codebook over the values of w (1-D Lloyd on a
    subsample)."""
    flat = w.reshape(*w.shape[:batch], -1).to(torch.float32)
    n = flat.shape[-1]
    if n > SAMPLE:
        flat = flat[..., 0:SAMPLE * (n // SAMPLE):n // SAMPLE]
    s = torch.sort(flat, dim=-1).values
    ns = s.shape[-1]
    # the quantile positions in f32, as the reference computes them
    pos = ((torch.arange(k, dtype=torch.float32, device=s.device) + 0.5) / k
           * ns).to(torch.int64).clamp(0, ns - 1)
    cb = s[..., pos]
    for _ in range(iters):
        d = torch.abs(flat[..., :, None] - cb[..., None, :])     # (.., n, k)
        oh = torch.nn.functional.one_hot(torch.argmin(d, dim=-1), k).to(
            torch.float32)
        tot = oh.sum(-2)
        cb_new = (oh.transpose(-1, -2) @ flat[..., None])[..., 0] \
            / torch.clamp_min(tot, 1.0)
        cb = torch.where(tot > 0, cb_new, cb)             # keep empty clusters
    return cb


def assign_codebook(w: torch.Tensor, cb: torch.Tensor,
                    batch: int = 0) -> torch.Tensor:
    """Nearest-codeword index per weight (int64)."""
    cbb = cb.reshape(*cb.shape[:batch], *([1] * (w.dim() - batch)), -1)
    return torch.argmin(torch.abs(w[..., None].to(torch.float32) - cbb), dim=-1)


class ClusterSTE(torch.autograd.Function):
    @staticmethod
    def forward(w, k, iters, batch):
        cb = kmeans_codebook(w, k, iters, batch)
        idx = assign_codebook(w, cb, batch)
        flat_idx = idx.reshape(*idx.shape[:batch], -1)
        return torch.gather(cb, -1, flat_idx).reshape(w.shape).to(w.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def cluster_ste(w: torch.Tensor, k: int, iters: int = 8,
                batch: int = 0) -> torch.Tensor:
    return ClusterSTE.apply(w, k, iters, batch)
