"""Public wrapper of the fleet_aggregate CUDA kernel
(``csrc/fleet_aggregate.cu``): the heterogeneous aggregation of every
leaf of an FL round in one launch (up to ``MAX_LEAVES`` leaves a launch).
Each tier's update and mask are read where they lie: nothing is stacked,
copied or converted per call, so the launch can be captured in a CUDA
graph. CUDA tensors launch the kernel or raise; CPU tensors take the
plain version in ``ref.py``. There is no fallback from one to the other.

The launch's argument block is one preallocated ctypes structure that
mirrors the kernel's ``FleetArgs``, passed by address. A leaf signature
(global shape, tier shapes, mask sizes) is checked once and its part of
the block cached, so a call checks each tensor's dtype and contiguity,
reads its address and copies the cached part in.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.fleet_aggregate.ref import aggregate_leaf_ref, view2d

MAX_TIERS = 8
MAX_LEAVES = 16
THREADS = 256
MAX_ELEMENTS = 2 ** 31 - 1    # per leaf: the kernel indexes in 32 bits
EPS = 1e-8
_F32 = torch.float32
_U64, _I32, _F = ctypes.c_uint64, ctypes.c_int32, ctypes.c_float


class FleetArgs(ctypes.Structure):
    """The kernel's by-value argument block, field for field."""
    _fields_ = [("g", _U64 * MAX_TIERS * MAX_LEAVES),
                ("m", _U64 * MAX_TIERS * MAX_LEAVES),
                ("out", _U64),
                ("out_off", ctypes.c_int64 * MAX_LEAVES),
                ("rows", _I32 * MAX_TIERS * MAX_LEAVES),
                ("cols", _I32 * MAX_TIERS * MAX_LEAVES),
                ("R", _I32 * MAX_LEAVES),
                ("C", _I32 * MAX_LEAVES),
                ("scalar_bits", _I32 * MAX_LEAVES),
                ("block_start", _I32 * (MAX_LEAVES + 1)),
                ("wn", _F * MAX_TIERS),
                ("wd", _F * MAX_TIERS),
                ("eps", _F),
                ("n_tiers", _I32),
                ("n_leaves", _I32)]


# the block's fields fixed by the leaves' signatures alone
_STATIC = slice(FleetArgs.out_off.offset, FleetArgs.wn.offset)


class _Launcher:
    """The bound C entry point, the argument block with a numpy view of
    its address fields, and the weights last written to it (one per
    process, made at the first launch)."""

    def __init__(self, lib):
        size = lib.fleet_aggregate_args_size()
        if size != ctypes.sizeof(FleetArgs):
            raise RuntimeError(f"FleetArgs is {size} bytes in the kernel, "
                               f"{ctypes.sizeof(FleetArgs)} here")
        self.fn = lib.fleet_aggregate_launch
        self.fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        self.fn.restype = ctypes.c_int
        # a leaf's blocks at most: one wave of the card (grid-stride loop)
        self.wave = lib.fleet_aggregate_resident_blocks()
        if self.wave <= 0:
            raise RuntimeError("fleet_aggregate: no occupancy for the kernel")
        self.args = FleetArgs()
        self.addr = ctypes.addressof(self.args)
        # g and m side by side: (2, MAX_LEAVES, MAX_TIERS) addresses
        self.ptrs = np.frombuffer(self.args, np.uint64,
                                  2 * MAX_LEAVES * MAX_TIERS).reshape(
                                      2, MAX_LEAVES, MAX_TIERS)
        self.weights = None


@functools.lru_cache(maxsize=None)
def _launcher() -> _Launcher:
    return _Launcher(load("fleet_aggregate"))


def leaf_blocks(R: int, C: int, wave: int) -> int:
    """A leaf's blocks: one thread per quad of columns (per element when
    C is not a multiple of 4), at most one wave."""
    items = R * C // 4 if C % 4 == 0 else R * C
    return min(-(-items // THREADS), wave)


class _Geometry:
    """One leaf signature, checked once: the global 2-D view (R, C), each
    tier's (r_t, c_t), the scalar-mask bits, its slab size (padded to 16
    bytes) and its output view's shape and strides."""
    __slots__ = ("R", "C", "rows", "cols", "sbits", "size", "shape",
                 "strides")

    def __init__(self, shape: tuple, gshapes: tuple, mnumels: tuple):
        self.R, self.C = view2d(shape)
        if self.R * self.C > MAX_ELEMENTS:
            raise ValueError(f"leaf {shape} has more than {MAX_ELEMENTS} "
                             "elements")
        rows, cols, sbits = [], [], 0
        for t, (loc, mn) in enumerate(zip(gshapes, mnumels)):
            if not (len(loc) == len(shape) and
                    all(a <= b for a, b in zip(loc, shape)) and
                    tuple(loc[1:-1]) == tuple(shape[1:-1])):
                raise ValueError(f"tier shape {tuple(loc)} is not a prefix "
                                 f"block of {tuple(shape)}")
            if mn != 1 and mn != math.prod(loc):
                raise ValueError(f"mask of {mn} elements for an update of "
                                 f"shape {tuple(loc)}")
            r, c = view2d(tuple(loc))
            rows.append(r)
            cols.append(c)
            sbits |= (mn == 1) << t
        self.rows, self.cols, self.sbits = tuple(rows), tuple(cols), sbits
        self.size = -(-self.R * self.C // 4) * 4
        self.shape = tuple(shape)
        strides, n = [], 1
        for d in reversed(self.shape):
            strides.append(n)
            n *= d
        self.strides = tuple(reversed(strides))


# caches of values derived from their keys alone: one entry per leaf
# signature, and per group of signatures launched together, seen
_GEOMETRY: dict = {}
_CHUNKS: dict = {}


def _plan(leaves, t: int):
    """Check every leaf against what the kernel takes (dtype, contiguity;
    prefix blocks and mask sizes once per signature). Returns each leaf's
    geometry and its tensors, g and m per tier, in leaf order."""
    if not 1 <= t <= MAX_TIERS:
        raise ValueError(f"fleet_aggregate takes 1..{MAX_TIERS} tiers, "
                         f"got {t}")
    geos, flat = [], []
    for shape, tiers in leaves:
        if len(tiers) != t:
            raise ValueError(f"a leaf has {len(tiers)} tiers, the weights {t}")
        key = [tuple(shape)]
        for g, m in tiers:
            if g.dtype is not _F32 or m.dtype is not _F32:
                raise TypeError(f"fleet_aggregate takes float32, got "
                                f"{g.dtype}/{m.dtype}")
            mn = m.numel()
            if not g.is_contiguous() or (mn != 1 and not m.is_contiguous()):
                raise ValueError("fleet_aggregate takes contiguous updates "
                                 "and masks")
            key += (g.shape, mn)
            flat.append(g)
            flat.append(m)
        key = tuple(key)
        geo = _GEOMETRY.get(key)
        if geo is None:
            geo = _GEOMETRY[key] = _Geometry(key[0], key[1::2], key[2::2])
        geos.append(geo)
    return geos, flat


def _chunk(geos: tuple, wave: int) -> tuple[bytes, int]:
    """The static part of the argument block of one launch over ``geos``
    (slab offsets from the first leaf's) and the launch's grid."""
    hit = _CHUNKS.get(geos)
    if hit is None:
        a = FleetArgs()
        rows = np.ctypeslib.as_array(a.rows)
        cols = np.ctypeslib.as_array(a.cols)
        off, start = 0, 0
        for k, geo in enumerate(geos):
            rows[k, :len(geo.rows)] = geo.rows
            cols[k, :len(geo.cols)] = geo.cols
            a.R[k], a.C[k], a.scalar_bits[k] = geo.R, geo.C, geo.sbits
            a.out_off[k], a.block_start[k] = off, start
            off += geo.size
            start += leaf_blocks(geo.R, geo.C, wave)
        a.block_start[len(geos)] = start
        hit = _CHUNKS[geos] = (bytes(a)[_STATIC], start)
    return hit


def _launch(geos, flat, wn, wd, eps, slab) -> None:
    """Launch over every leaf, ``MAX_LEAVES`` a time: per launch one copy
    of the cached static part, the tensors' addresses and the weights."""
    L = _launcher()
    dev = slab.get_device()
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(geos, flat, wn, wd, eps, slab)
    # the raw handle: torch.cuda.current_stream() builds a Stream object
    # inside a device context, a large part of a small call's host time
    stream = torch._C._cuda_getCurrentRawStream(dev)
    t = len(wn)
    ptrs = np.array([x.data_ptr() for x in flat],
                    np.uint64).reshape(-1, t, 2).transpose(2, 0, 1)
    a = L.args
    if L.weights != (wn, wd, eps):
        L.weights = (list(wn), list(wd), eps)
        a.wn[:t], a.wd[:t] = wn, wd
        a.eps = eps
        a.n_tiers = t
    base = slab.data_ptr()
    for c0 in range(0, len(geos), MAX_LEAVES):
        chunk = tuple(geos[c0:c0 + MAX_LEAVES])
        n = len(chunk)
        static, grid = _chunk(chunk, L.wave)
        ctypes.memmove(L.addr + _STATIC.start, static, len(static))
        L.ptrs[:, :n, :t] = ptrs[:, c0:c0 + n]
        a.out = base
        a.n_leaves = n
        base += 4 * sum(geo.size for geo in chunk)
        rc = L.fn(L.addr, grid, stream)
        if rc != 0:
            raise RuntimeError(f"fleet_aggregate kernel launch failed: "
                               f"cudaError {rc}")
        fleet_aggregate.launches += 1


def aggregate(leaves, wn, wd, eps: float = EPS):
    """The grouped aggregation over ``(global_shape, [(g_t, m_t), ...])``
    leaves; returns the f32 slab and each leaf's geometry and offset in it
    (in floats, a multiple of 4: 16-byte aligned)."""
    geos, flat = _plan(leaves, len(wn))
    offs, total = [], 0
    for geo in geos:
        offs.append(total)
        total += geo.size
    if flat and flat[0].is_cuda:
        if {x.get_device() for x in flat} != {flat[0].get_device()}:
            raise ValueError("fleet_aggregate takes tensors on one device")
        slab = torch.empty(total, dtype=_F32, device=flat[0].device)
        _launch(geos, flat, wn, wd, eps, slab)
        return slab, geos, offs
    if not all(x.is_cpu for x in flat):
        raise ValueError("fleet_aggregate takes CPU or CUDA tensors on one "
                         "device")
    wn = np.asarray(wn, np.float32).tolist()
    wd = np.asarray(wd, np.float32).tolist()
    slab = torch.empty(total, dtype=_F32)
    for (_, tiers), geo, off in zip(leaves, geos, offs):
        res = aggregate_leaf_ref(geo.shape, tiers, wn, wd, eps)
        slab[off:off + res.numel()] = res.reshape(-1)
    return slab, geos, offs


def fleet_aggregate(leaves: dict, wn, wd, eps: float = EPS) -> dict:
    """Aggregate every leaf of a round in one launch (per ``MAX_LEAVES``).

    ``leaves``: name -> ``(global_shape, [(g_t, m_t) for each tier])``,
    ``g_t`` the tier's update at its LOCAL shape (the global shape, or a
    prefix block of it from ``submodel_spec``), contiguous; ``m_t`` its
    0/1 mask at the same shape or one value (any shape of one element).
    ``wn``, ``wd``: T numerator and denominator weights, Python floats
    holding f32 values (``aggregation.f32``). Returns name -> the
    aggregated f32 leaf, views into one slab — bitwise the sequential
    ``accumulate_cohort`` / ``scatter_accumulate`` -> ``finalize``."""
    slab, geos, offs = aggregate(leaves.values(), wn, wd, eps)
    return {k: slab.as_strided(geo.shape, geo.strides, off)
            for k, geo, off in zip(leaves, geos, offs)}


fleet_aggregate.launches = 0
