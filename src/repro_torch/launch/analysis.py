"""Roofline terms of a step, counted on fake tensors, as the reference's
``launch/analysis.py`` counts them on the jaxpr.

:func:`analyze_step` runs the step once under a ``FakeTensorMode`` (no
tensor storage is allocated, so full-scale configs trace on a host) and
one ``TorchDispatchMode`` that sees every ATen op the step dispatches,
forward and backward, and applies the reference's rule:

  - a matmul or a convolution (an op in ``torch.utils.flop_counter``'s
    registry): its flops by that registry's formulas, plus its operand
    and result bytes (a broadcast operand's distinct elements: torch's
    matmul may fold a weight into a ``bmm`` over its expanded view);
  - every other op: its output bytes (a fusion-friendly estimate:
    elementwise chains are counted once, not per operand);
  - views: nothing, and ``_unsafe_view`` (a reshape sharing its input's
    storage) neither.

The rule is the reference's; the ops are not. The matmul and convolution
term (``matmul_traffic_bytes``) equals the reference's at the dense and
audio configs. The rest counts ATen ops where the reference counts jaxpr
equations: the reference's broadcasts, slices and reshapes are
equations, its softmax, silu, tanh-GELU and means several, its KV-cache
write a select over the whole cache; the port's einsums copy their
operands. ``tests/test_torch_analysis.py`` computes that difference from
the shapes for each dense and audio config, and ROADMAP queue 3 lists it.

A scan from Python (``models.layers.scan``: the sLSTM's loop over time,
the mLSTM's and Mamba2's loops over chunks) traces two of its N steps
and scales the second's counts by N - 1, the reference's rule for a
``lax.scan``'s length (its jaxpr walk multiplies a scan body by its
length). Flops are GLOBAL, before any partitioning.

The same mode tracks the step's live bytes: each op's new storages,
released when the last tensor on them dies (weakref callbacks), so the
peak beyond the step's arguments is the trace's temp bytes. Under a
scan's multiplier the loop's memory is that of its two traced steps, so
the peak is then a lower bound (``scans_repeated``).

It also counts the step's collectives (``models.parallel.Census``), a
scan's times its multiplier. A step traced inside ``parallel.using`` a
census mesh (``launch.mesh.census_mesh``) on one rank's arguments is
that rank's program: its collectives are the rank's, and so are its
live bytes and their peak; its flops and traffic are the rank's share.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map_only

from repro_torch.models import parallel


def _tensors(tree, out=None) -> list:
    """The tensors of nested lists, tuples and dicts, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _read_bytes(tensors) -> int:
    """Bytes of the distinct elements the tensors hold: a broadcast dim
    (stride 0, as ``expand`` makes) is read once."""
    n = 0
    for t in tensors:
        k = t.element_size()
        for size, stride in zip(t.shape, t.stride()):
            k *= size if stride else 1
        n += k
    return n


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


_DEVICE = torch.ops.prim.device.default
# a reshape that shares its input's storage (a matmul's folded output, a
# reshape of a copy): it moves nothing, as a view
_UNSAFE_VIEW = torch.ops.aten._unsafe_view.default


class _Alloc:
    __slots__ = ("nbytes", "refs")

    def __init__(self, nbytes: int):
        self.nbytes = nbytes
        self.refs = 0


class StepCounter(TorchDispatchMode):
    """Counts flops and traffic of the ops dispatched under it (times
    ``mult``), and the peak bytes of the storages they create. With
    ``repeats_scans`` a ``models.layers.scan`` under it traces two steps
    and scales the second by the rest of its length; without, the loop
    runs step by step."""

    def __init__(self, args, repeats_scans: bool = True):
        super().__init__()
        self.repeats_scans = repeats_scans
        self.scans_repeated = False
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.mult = 1
        self.flops = 0
        self.traffic = 0
        self.matmul_traffic = 0
        self.live = 0
        self.peak = 0
        self._allocs: dict[int, _Alloc] = {}
        self._refs: dict[int, tuple] = {}
        self._args = {_storage_key(t) for t in _tensors(args)}
        self.census = parallel.Census()

    @contextlib.contextmanager
    def scaled(self, n: int):
        """Counts inside scaled by ``n`` (0: uncounted), the collectives'
        too."""
        prev = self.mult
        self.mult = self.census.mult = prev * n
        self.scans_repeated |= n > 1
        try:
            yield self
        finally:
            self.mult = self.census.mult = prev

    def _release(self, ref) -> None:
        key = self._refs.pop(id(ref))[1]
        a = self._allocs[key]
        a.refs -= 1
        if a.refs == 0:
            self.live -= a.nbytes
            del self._allocs[key]

    def _track(self, outs: list) -> None:
        """Each output tensor holds its storage until it dies."""
        for t in outs:
            key = _storage_key(t)
            if key in self._args:
                continue
            a = self._allocs.get(key)
            if a is None:
                a = self._allocs[key] = _Alloc(t.untyped_storage().nbytes())
                self.live += a.nbytes
                self.peak = max(self.peak, self.live)
            a.refs += 1
            ref = weakref.ref(t, self._release)
            self._refs[id(ref)] = ref, key

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is _DEVICE:                 # a query: no op, no storage
            return out
        outs = _tensors(out)
        if self.mult:
            formula = self._formulas.get(func._overloadpacket)
            if formula is not None:
                self.flops += self.mult * formula(*args, **kwargs,
                                                  out_val=out)
                moved = self.mult * (
                    _read_bytes(_tensors((args, kwargs))) + _bytes(outs))
                self.traffic += moved
                self.matmul_traffic += moved
            elif not (func.is_view or func is _UNSAFE_VIEW):
                self.traffic += self.mult * _bytes(outs)
        self._track(outs)
        return out


def fake_inputs(args):
    """(``args`` with every real tensor made a fake tensor, the fake mode
    they belong to): the fake tensors' own mode if any, else a new one."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    mode = None
    for t in _tensors(args):
        if isinstance(t, FakeTensor):
            mode = t.fake_mode
            break
    if mode is None:
        mode = FakeTensorMode(allow_non_fake_inputs=True)
    return tree_map_only(
        torch.Tensor,
        lambda t: t if isinstance(t, FakeTensor) else mode.from_tensor(t),
        args), mode


def trace_step(step, *args,
               repeats_scans: bool = True) -> tuple[dict, object]:
    """Runs ``step(*args)`` on fake tensors under a :class:`StepCounter`.
    Returns ({"flops", "traffic_bytes", "matmul_traffic_bytes",
    "temp_bytes", "temp_exact", "collectives"}, the step's fake outputs):
    ``matmul_traffic_bytes`` is the matmul and convolution term of the
    traffic, ``temp_exact`` False when a scan was counted by its
    multiplier, ``collectives`` the census's record (``bytes_by_op``,
    ``count_by_op``, ``total_bytes``; empty off a mesh of ranks)."""
    args, mode = fake_inputs(args)
    counter = StepCounter(args, repeats_scans)
    with mode, counter, parallel.counting(counter.census):
        out = step(*args)
    return {"flops": float(counter.flops),
            "traffic_bytes": float(counter.traffic),
            "matmul_traffic_bytes": float(counter.matmul_traffic),
            "temp_bytes": int(counter.peak),
            "temp_exact": not counter.scans_repeated,
            "collectives": counter.census.record()}, out


def analyze_step(step, *args) -> dict[str, float]:
    """Returns {"flops", "traffic_bytes"} of one call of ``step``."""
    counts, _ = trace_step(step, *args)
    return {"flops": counts["flops"],
            "traffic_bytes": counts["traffic_bytes"]}


def nbytes(tree) -> int:
    """Bytes of every tensor of nested lists, tuples and dicts."""
    return _bytes(_tensors(tree))
