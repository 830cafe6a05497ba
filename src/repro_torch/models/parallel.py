"""The collectives that GSPMD inserts into the reference's sharded train,
prefill and decode steps, written out for a mesh of ``torch.distributed``
ranks.

The reference places each leaf by its PartitionSpec and lets the
partitioner insert the communication; here every rank holds its own
block of each leaf as a plain tensor (``models.sharding.place``) and the
model calls these functions where a layer's layout changes: Megatron's
column- then row-parallel pairs on the "model" axis, and the FSDP
gathers of leaves split over the data axes too.

- :func:`copy_to_model`: identity forward, all-reduce backward (the
  replicated input of a column-split projection);
- :func:`reduce_from_model`: all-reduce forward, identity backward (the
  partial sums of a row-split projection);
- :func:`gather_from_model` / :func:`split_to_model`: all-gather along a
  dim forward and this rank's block backward, and the converse;
- :func:`gather_to_ranks`: all-gather forward, all-reduce then this
  rank's block backward (a whole tensor of which each rank uses its own
  part, as attention's kv heads under the head_dim fallback);
- :func:`softmax_over`: the softmax of scores split along their last
  dim (flash-decoding's max and sum of exponentials over the ranks;
  the partial ``p @ v`` are summed by :func:`sum_over`);
- :func:`mean_over_data`: the mean over the data axes (:data:`DATA`)
  forward, the gradient passed through whole (the MoE layer's expert
  load over a batch split by rows, whose step averages the gradients
  over those axes after);
- :func:`gather_blocks`: all-gather over the data axes forward,
  reduce-scatter backward (the sum over those ranks, this rank's block):
  a leaf of the FSDP train state made whole where a layer uses it; under
  :func:`regathering` the backward gathers a layer's leaf again where it
  needs it, so no whole layer is kept for the backward.

:func:`using` is the counterpart of the reference's ``with mesh:``: it
holds the current mesh, as ``sharding.set_rules`` holds the hints.
Outside it, or on a mesh of one process, or along an axis of size 1,
every function returns its input itself, so the one-process path runs
exactly the operations it ran before.

:func:`rows_whole` runs a block as if the data axes had one rank each
(a serve step whose batch does not divide over them holds it whole on
every rank).

Every collective passes through one place that counts it into the
active :class:`Census` (:func:`counting`), with the bytes of its result
on this rank, beside the real collective on a mesh of ranks. On a census
mesh (``launch.mesh.census_mesh``: a mesh's shape with no process group
behind it) the collectives are counted and make their results' shapes
without calling ``torch.distributed``, so one rank's step of a
production mesh traces on fake tensors in one process
(``launch.specs.rank_traced``). With no census active the collectives
run exactly as without one. ``all_reduce``, ``all_gather``
and ``reduce_scatter_tensor`` are used: gloo takes all three on CUDA
tensors (checked on the H100 host with torch 2.11,
``launch/probe_collectives.py``), so ranks that share one card need no
host copy here.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

_MESH = None
_WHOLE_ROWS = False
# the axes a batch is split over by rows, row-major (the multi-pod mesh's
# "pod" outermost); a mesh without "pod" has "data" alone
DATA = ("pod", "data")


@contextlib.contextmanager
def using(mesh):
    """Runs the block with ``mesh`` as the current mesh (None: none)."""
    global _MESH
    before, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = before


def current():
    return _MESH


def multi_rank() -> bool:
    """True inside :func:`using` a mesh over several ranks."""
    return _MESH is not None and _MESH.is_distributed


@contextlib.contextmanager
def rows_whole(whole: bool = True):
    """Runs the block (where ``whole``) as if the data axes
    (:data:`DATA`) had one rank each: every rank holds the whole batch,
    as a serve step's ranks do where its rows do not divide over those
    axes (the reference then replicates the batch over them), so the
    layers take no data rank's rows and run no collective there."""
    global _WHOLE_ROWS
    before, _WHOLE_ROWS = _WHOLE_ROWS, _WHOLE_ROWS or whole
    try:
        yield
    finally:
        _WHOLE_ROWS = before


def group(axis: str, mesh=None):
    """The process group of this rank's line along ``axis`` of ``mesh``
    (default: the current one), or None where there is nothing to
    communicate (no mesh, one process, size 1)."""
    mesh = _MESH if mesh is None else mesh
    if mesh is None or not mesh.is_distributed \
            or mesh.shape.get(axis, 1) == 1 \
            or (_WHOLE_ROWS and axis in DATA):
        return None
    return mesh.groups[axis]


def _axes(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def size(axis) -> int:
    """The current mesh's size along ``axis`` (a name, or a tuple of
    names: their sizes' product): its ranks there, 1 outside a mesh of
    several ranks."""
    if not multi_rank():
        return 1
    return math.prod(_MESH.shape.get(a, 1) for a in _axes(axis)
                     if not (_WHOLE_ROWS and a in DATA))


def rank(axis) -> int:
    """This rank's slot along ``axis`` (over a tuple of names, row-major,
    the last innermost), 0 outside a mesh of several ranks."""
    if not multi_rank():
        return 0
    coords, idx = _MESH.coords(), 0
    for a in _axes(axis):
        if a in coords and not (_WHOLE_ROWS and a in DATA):
            idx = idx * _MESH.shape[a] + coords[a]
    return idx


# ------------------------------------------------------------- the census

class Census:
    """The collectives run while it is counting (:func:`counting`): op (the
    reference's names: ``all-reduce``, ``all-gather``,
    ``reduce-scatter``) -> how many, and -> the bytes of their results on
    this rank (a gather's whole tensor, a reduce-scatter's block), each
    times ``mult``: a scan traced by its multiplier
    (``launch.analysis.StepCounter.scaled``) counts its body's
    collectives times its length, as the reference counts a while body
    times its trip count."""

    def __init__(self):
        self.count_by_op: dict[str, int] = {}
        self.bytes_by_op: dict[str, int] = {}
        self.mult = 1

    def add(self, op: str, nbytes: int) -> None:
        if self.mult:
            self.count_by_op[op] = self.count_by_op.get(op, 0) + self.mult
            self.bytes_by_op[op] = self.bytes_by_op.get(op, 0) \
                + self.mult * nbytes

    def record(self) -> dict:
        """The reference's ``collective_bytes`` keys: ``bytes_by_op``,
        ``count_by_op`` and ``total_bytes``."""
        return {"bytes_by_op": dict(sorted(self.bytes_by_op.items())),
                "count_by_op": dict(sorted(self.count_by_op.items())),
                "total_bytes": sum(self.bytes_by_op.values())}


_CENSUS: Census | None = None


@contextlib.contextmanager
def counting(census: Census | None = None):
    """Counts every collective of the block into ``census`` (a new
    :class:`Census` by default), which it yields. Outside it nothing is
    counted."""
    global _CENSUS
    census = Census() if census is None else census
    before, _CENSUS = _CENSUS, census
    try:
        yield census
    finally:
        _CENSUS = before


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _sent(op: str, nbytes: int, mesh) -> bool:
    """Counts ``op``, whose result on this rank has ``nbytes``; True where
    it is to be sent (not on a census mesh, which has no process
    group)."""
    if _CENSUS is not None:
        _CENSUS.add(op, nbytes)
    return not mesh.is_census


# ------------------------------------------- plain (untracked) collectives
# On a census mesh each makes its result as the real one does, a tensor
# of its shape and dtype, and calls nothing in ``torch.distributed``.

def all_reduce(x: torch.Tensor, axis, op=dist.ReduceOp.SUM,
               mesh=None):
    """The all-reduce of ``x`` over ``axis`` of ``mesh`` (default: the
    current one), a new tensor; ``x`` itself where there is nothing to
    reduce. Over a tuple of axes, one all-reduce along each in turn."""
    mesh = _MESH if mesh is None else mesh
    out = x
    for a in _axes(axis):
        g = group(a, mesh)
        if g is None:
            continue
        if out is x:
            out = x.detach().clone()
        if _sent("all-reduce", _nbytes(out), mesh):
            dist.all_reduce(out, op=op, group=g)
    return out


def sum_over(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """:func:`all_reduce` of the partial sums ``x``, as the reference's
    sharded step sums them: a bf16 or f16 ``x`` is summed in f32 and
    rounded once to its dtype. Over two ranks gloo's sum in ``x``'s dtype
    gives the same bits (one addition, rounded once) and moves half the
    bytes, so the cast is made over three ranks or more only."""
    mesh = _MESH if mesh is None else mesh
    if group(axis, mesh) is not None \
            and x.dtype in (torch.bfloat16, torch.float16) \
            and mesh.shape[axis] > 2:
        return all_reduce(x.to(torch.float32), axis, mesh=mesh).to(x.dtype)
    return all_reduce(x, axis, mesh=mesh)


def softmax_over(scores: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """This rank's block of the softmax along the last dim of f32
    ``scores``, whose last dim is split over ``axis``'s ranks (each rank
    its block; flash-decoding's partial scores over its block of the
    cached positions): the max over the ranks' blocks (an all-reduce of
    the rows' maxima), then the sum of the exponentials over them (an
    all-reduce of the rows' partial sums). The probabilities are
    ``exp(s - max) / sum`` as one rank's softmax computes them; the sum
    of their products with each rank's values is the caller's
    (:func:`sum_over`)."""
    m = all_reduce(scores.amax(dim=-1, keepdim=True), axis,
                   dist.ReduceOp.MAX, mesh)
    e = torch.exp(scores - m)
    return e / all_reduce(e.sum(dim=-1, keepdim=True), axis, mesh=mesh)


def all_gather(x: torch.Tensor, axis, dim: int,
               mesh=None) -> torch.Tensor:
    """The blocks of ``axis``'s ranks concatenated along ``dim``, in rank
    order; ``x`` itself where there is nothing to gather. Over a tuple of
    axes (row-major, the last innermost) the innermost is gathered
    first."""
    mesh = _MESH if mesh is None else mesh
    for a in reversed(_axes(axis)):
        g = group(a, mesh)
        if g is None:
            continue
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.shape[a])]
        if _sent("all-gather", _nbytes(x) * len(parts), mesh):
            dist.all_gather(parts, x, group=g)
        x = torch.cat(parts, dim=dim)
    return x


def reduce_scatter(x: torch.Tensor, axis: str, dim: int,
                   mesh=None) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over ``axis``'s
    ranks (``x`` split evenly there, as :func:`block` cuts it), a new
    tensor; ``x`` itself where there is nothing to reduce. A bf16 or f16
    ``x`` is summed in f32 over three ranks or more and rounded once, as
    :func:`sum_over` sums."""
    mesh = _MESH if mesh is None else mesh
    g = group(axis, mesh)
    if g is None:
        return x
    n = mesh.shape[axis]
    wide = x.dtype in (torch.bfloat16, torch.float16) and n > 2
    src = x.detach().movedim(dim, 0)
    src = (src.to(torch.float32) if wide else src).contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    if _sent("reduce-scatter", _nbytes(out), mesh):
        dist.reduce_scatter_tensor(out, src, group=g)
    return out.to(x.dtype).movedim(0, dim).contiguous()


def block(x: torch.Tensor, axis: str, dim: int, mesh=None) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (``x`` split evenly over
    ``axis`` of ``mesh``, default the current one)."""
    if group(axis, mesh) is None:
        return x
    mesh = _MESH if mesh is None else mesh
    n = mesh.shape[axis]
    return x.chunk(n, dim=dim)[mesh.coords()[axis]].contiguous()


# ------------------------------------------------- differentiable forms
# Each keeps the mesh of its forward, so that its backward reduces over
# the same ranks wherever the backward runs.

class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.mesh = axis, _MESH
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_over(g, ctx.axis, ctx.mesh), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return sum_over(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, _MESH
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return block(g, ctx.axis, ctx.dim, ctx.mesh), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, _MESH
        return block(x, axis, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axis, ctx.dim, ctx.mesh), None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` (replicated over "model") as the input of a column-split
    projection: its gradient, a partial sum on each rank, is summed
    (:func:`sum_over`)."""
    return x if group("model") is None else _Copy.apply(x, "model")


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over "model" of each rank's partial ``x`` (a row-split
    projection's output, summed by :func:`sum_over`); the gradient
    passes through."""
    return x if group("model") is None else _Reduce.apply(x, "model")


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Each rank's block of a tensor split over "model" along ``dim``,
    gathered whole; the gradient keeps this rank's block."""
    return x if group("model") is None else _Gather.apply(x, "model", dim)


def split_to_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x`` (replicated over
    "model"); the gradient blocks are gathered whole."""
    return x if group("model") is None else _Split.apply(x, "model", dim)


def gather_to_ranks(x: torch.Tensor, dim: int) -> torch.Tensor:
    """:func:`gather_from_model` for a use that differs per rank: each
    rank's gradient of the whole tensor is partial, so it is summed over
    "model" before this rank's block is kept."""
    return copy_to_model(gather_from_model(x, dim))


class _DataMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce(x, DATA) / size(DATA)

    @staticmethod
    def backward(ctx, g):
        return g


def mean_over_data(x: torch.Tensor) -> torch.Tensor:
    """The mean over the data axes of each rank's ``x``, its gradient
    passed to every rank whole: the step averages the ranks' gradients
    over those axes (``core.steps``), which then sums each rank's share
    once."""
    return (_DataMean.apply(x) if any(group(a) is not None for a in DATA)
            else x)


# ------------------------------------------------------------------- FSDP

class _Regather:
    """How the backward makes a gathered leaf whole again: its block, the
    dim and axes it is split along, the mesh; the whole leaf once made,
    kept while a saved use of it is alive (every such use holds this
    object, so the leaf goes with the last of them)."""

    def __init__(self, blk: torch.Tensor, dim: int, axes: tuple, mesh):
        self.block, self.dim, self.axes, self.mesh = blk, dim, axes, mesh
        self.whole = None

    def get(self) -> torch.Tensor:
        if self.whole is None:
            x = self.block
            for a in reversed(self.axes):
                x = all_gather(x, a, self.dim, self.mesh)
            self.whole = x
        return self.whole


class _BlockGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, _MESH
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.axis, ctx.dim, ctx.mesh), None, None


def gather_blocks(x: torch.Tensor, dim: int, axes: tuple,
                  regather: bool = True) -> torch.Tensor:
    """``x``, this rank's block of a leaf split along ``dim`` over the mesh
    ``axes`` (row-major, the last innermost: a data entry of its
    PartitionSpec), gathered whole; its gradient is reduce-scattered, the
    sum over those ranks of their gradients of the whole leaf, this
    rank's block kept. With ``regather`` the whole leaf carries the
    recipe that :func:`regathering` saves in its place; without, autograd
    keeps it for the backward. ``x`` itself where no axis has several
    ranks."""
    axes = tuple(a for a in axes if group(a) is not None)
    if not axes:
        return x
    whole = x
    for a in reversed(axes):
        whole = _BlockGather.apply(whole, a, dim)
    if regather:
        whole._regather = _Regather(x.detach(), dim, axes, _MESH)
    return whole


def _pack(t: torch.Tensor):
    base = t if t._base is None else t._base
    recipe = getattr(base, "_regather", None)
    if recipe is None or t.dtype != base.dtype:
        return t
    return recipe, t.size(), t.stride(), t.storage_offset()


def _unpack(packed):
    if isinstance(packed, torch.Tensor):
        return packed
    recipe, size, stride, offset = packed
    return recipe.get().as_strided(size, stride, offset)


def regathering():
    """A context under which a tensor that autograd saves for the backward
    and that is (a view of) a leaf made whole by :func:`gather_blocks` is
    saved as its recipe, and gathered again when the backward reads it:
    the whole leaves of every layer are not kept alive from the forward
    to the backward. Other saved tensors are kept as they are."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)
