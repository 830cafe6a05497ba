"""Magnitude pruning by a log-bisection threshold (the reference's
algorithm, step for step: 16 halvings of a 12-decade log interval, each
counting the kept fraction with an elementwise compare and a mean).
``topk`` or ``quantile`` would break ties differently, so neither is
used.

Leading ``batch`` axes hold independent tensors (one per client of a
cohort): each gets its own threshold over its trailing axes.

:func:`magnitude_masks` prunes a whole model's leaves at one density.
Its small f32 leaves share one bisection over their rows padded side by
side, so each of its operations is one launch for all of them where the
per-leaf loop makes one a leaf: the FL runtimes' rounds on the card are
bound by the host's launches, most of them this loop's. Every element
sees the operations of :func:`magnitude_mask`, so the masks are its
bits, on the CPU as on the card.

On a mesh of several ranks (``shardings=``) a leaf split over "model",
over the data axes (FSDP) or both is one block on each rank: its largest
magnitude and each halving's count are all-reduced over the axes that
split it (MAX, SUM), so each rank's mask is the one-rank mask's block
wherever the one-rank count is exact (f32 sums of 0/1 are exact while
every partial sum stays below 2^24).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

ITERS = 16
EPS = 1e-12            # dynamic range of the log search (12 decades)
TINY = 2.0 ** -126     # the least normal f32
SMALL = 1 << 16        # elements a row of a leaf that shares the bisection


def _flush(x: torch.Tensor) -> torch.Tensor:
    """x with f32 subnormals flushed to 0, as the reference's backends
    (XLA on the CPU, the TPU) compute the threshold's bounds: for a leaf
    whose largest |w| is below ~1e-26 (an all-zero bias at init) the
    lower bound amax * EPS is subnormal, the reference's is 0, and its
    mask keeps every weight."""
    return torch.where(x.abs() < TINY, torch.zeros_like(x), x)


def _threshold(aw: torch.Tensor, density: float, batch: int) -> torch.Tensor:
    """|w| threshold such that ~`density` fraction of weights survive,
    one per leading batch index (kept broadcastable)."""
    dims = tuple(range(batch, aw.dim()))
    amax = torch.amax(aw, dim=dims, keepdim=True) + 1e-30
    lo = torch.log(_flush(amax * EPS))  # kept-fraction(exp(lo)) ~ 1
    hi = torch.log(amax)                # kept-fraction(exp(hi)) ~ 0
    n = float(aw[(0,) * batch].numel())
    for _ in range(ITERS):
        mid = 0.5 * (lo + hi)
        # sum / n, as the reference's mean: an exact count over an exact
        # divide, so `kept > density` decides alike at kept == density
        kept = torch.sum((aw >= _flush(torch.exp(mid))).to(torch.float32),
                         dim=dims, keepdim=True) / n
        # too many kept -> raise the threshold (move lo up), else lower hi
        up = kept > density
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    return _flush(torch.exp(lo))  # the >=density side of the bracket


@torch.no_grad()
def magnitude_mask(w: torch.Tensor, density: float,
                   batch: int = 0) -> torch.Tensor:
    """0/1 keep-mask, same dtype as w, never differentiated.
    density >= 1.0 short-circuits to all-ones."""
    if density >= 1.0:
        return torch.ones_like(w)
    aw = w.abs()
    return (aw >= _threshold(aw, density, batch)).to(w.dtype)


def _shared_thresholds(aws: list, density: float, batch: int) -> list:
    """``_threshold`` of each of ``aws`` (same dtype, same leading
    ``batch`` axes) from one bisection over their rows, padded with -1
    (below every threshold) into (*batch, leaves, widest row). Maxima and
    counts of 0/1 are exact in any order, ``exp`` and ``log`` act
    elementwise, and each count is divided by its leaf's size as the
    per-leaf loop divides it, so each threshold has the per-leaf bits."""
    lead = aws[0].shape[:batch]
    rows = [aw.reshape(*lead, -1) for aw in aws]
    width = max(r.shape[-1] for r in rows)
    flat = torch.stack([torch.nn.functional.pad(r, (0, width - r.shape[-1]),
                                                value=-1.0)
                        for r in rows], dim=batch)
    sizes = [float(r.shape[-1]) for r in rows]
    amax = torch.amax(flat, dim=-1, keepdim=True) + 1e-30
    lo = torch.log(_flush(amax * EPS))
    hi = torch.log(amax)
    for _ in range(ITERS):
        mid = 0.5 * (lo + hi)
        count = torch.sum((flat >= _flush(torch.exp(mid))).to(torch.float32),
                          dim=-1, keepdim=True)
        kept = torch.cat([c / n for c, n in zip(
            count.split(1, dim=batch), sizes)], dim=batch)
        up = kept > density
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    thr = _flush(torch.exp(lo))
    return [t.reshape(*lead, *([1] * (aw.dim() - batch)))
            for t, aw in zip(thr.split(1, dim=batch), aws)]


def _split_thresholds(aws: list, sizes: list, splits: list, density: float,
                      mesh) -> list:
    """``_threshold`` of each whole leaf of which ``aws`` holds this rank's
    blocks (``sizes``: the whole leaves' element counts; ``splits``: the
    mesh axes each leaf is split over), the bisections run in lockstep:
    one all-reduce over each splitting axis for the maxima and one for
    the counts of each halving. A leaf replicated along one of those axes
    counts on the ranks of coordinate 0 there alone, so each sum counts
    each element once."""
    # imported here: the models package imports this one
    from repro_torch.models import parallel

    axes = sorted({a for sp in splits for a in sp})
    coords = mesh.coords()
    own = torch.tensor([float(all(coords[a] == 0 for a in axes
                                  if a not in sp)) for sp in splits],
                       dtype=torch.float32, device=aws[0].device)

    def reduce(x, op):
        for a in axes:
            x = parallel.all_reduce(x, a, op, mesh=mesh)
        return x

    amax = reduce(torch.stack([torch.amax(aw) for aw in aws]),
                  dist.ReduceOp.MAX) + 1e-30
    lo = torch.log(_flush(amax * EPS))
    hi = torch.log(amax)
    for _ in range(ITERS):
        mid = 0.5 * (lo + hi)
        thr = _flush(torch.exp(mid))
        count = reduce(torch.stack([
            torch.sum((aw >= t).to(torch.float32))
            for aw, t in zip(aws, thr.unbind())]) * own, dist.ReduceOp.SUM)
        kept = torch.stack([c / n for c, n in zip(count.unbind(), sizes)])
        up = kept > density
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    return list(_flush(torch.exp(lo)).unbind())


def split_axes(s) -> tuple:
    """The mesh axes of several ranks over which the NamedSharding ``s``
    splits its leaf ("model", and the data axes of an FSDP entry), on a
    mesh of several ranks; () for any other leaf."""
    if s is None or not s.mesh.is_distributed:
        return ()
    return tuple(a for e in s.spec if e is not None
                 for a in ((e,) if isinstance(e, str) else e)
                 if s.mesh.shape[a] > 1)


@torch.no_grad()
def magnitude_masks(ws: dict, density: float, batch: int = 0,
                    shardings: dict | None = None) -> dict:
    """``magnitude_mask`` of each leaf of ``ws`` (name -> tensor, the same
    leading ``batch`` axes) at one density, bitwise. f32 leaves of at
    most SMALL elements a row share one bisection; the others take their
    own. ``shardings`` (name -> NamedSharding or None): on a mesh of
    several ranks, the leaves it splits (over "model", over the data axes
    of an FSDP entry, or both) are this rank's blocks of whole leaves,
    and their thresholds are the whole leaves' (:func:`_split_thresholds`);
    the rest are pruned as above."""
    if density >= 1.0:
        return {k: torch.ones_like(w) for k, w in ws.items()}
    splits = {k: split_axes((shardings or {}).get(k)) for k in ws}
    split = [k for k in ws if splits[k]]
    if split:
        if batch:
            raise ValueError("a leaf split over ranks takes no batch axes")
        mesh = shardings[split[0]].mesh
        rest = magnitude_masks({k: w for k, w in ws.items()
                                if k not in split}, density)
        aws = [ws[k].abs() for k in split]
        sizes = [float(aw.numel() * math.prod(mesh.shape[a]
                                              for a in splits[k]))
                 for k, aw in zip(split, aws)]
        for k, aw, t in zip(split, aws, _split_thresholds(
                aws, sizes, [splits[k] for k in split], density, mesh)):
            rest[k] = (aw >= t).to(ws[k].dtype)
        return {k: rest[k] for k in ws}
    shared = [k for k, w in ws.items()
              if w.dtype == torch.float32
              and w[(0,) * batch].numel() <= SMALL]
    out = {}
    if len(shared) > 1:
        aws = [ws[k].abs() for k in shared]
        for k, aw, t in zip(shared, aws,
                            _shared_thresholds(aws, density, batch)):
            out[k] = (aw >= t).to(ws[k].dtype)
    return {k: out[k] if k in out else magnitude_mask(w, density, batch)
            for k, w in ws.items()}
