"""Device meshes, as the reference's ``launch/mesh.py``.

A :class:`Mesh` is a numpy object array of ``torch.device`` slots with
one name per axis. The production meshes are the reference's TPU v5e
grids (one pod = 16 x 16 = 256 chips; two pods add a ``"pod"`` axis) as
abstract ``meta`` slots: the dry run shards shapes over them and places
nothing. The host mesh covers the devices that exist; under an
initialized ``torch.distributed`` process group it covers the world, one
slot per rank (:func:`init_distributed`, then :func:`make_host_mesh`),
and keeps each axis's process group for ``models/parallel.py``. A census
mesh (:func:`census_mesh`) has a mesh's shape and ranks but no process
group behind it: one rank's step runs on it with every collective counted
and none sent (the LM dry run's per-device census).

Defined as functions, so importing this module touches no device.
"""
from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch
import torch.distributed as dist


class CensusGroup:
    """The stand-in process group of one axis of a census mesh: its size,
    and no ranks behind it."""

    def __init__(self, axis: str, size: int):
        self.axis, self.size = axis, size


class Mesh:
    """``devices``: an object array of ``torch.device``; ``axis_names``:
    one name per axis of it. A mesh over the ranks of a process group
    also has ``ranks`` (the global rank of each slot, ``devices`` holding
    each rank's device) and ``groups`` (axis name -> the process group of
    this rank's line along that axis); a mesh of one process has
    neither. A census mesh also has ``census_rank``, the rank it answers
    for, and a :class:`CensusGroup` per axis."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...],
                 ranks: np.ndarray | None = None,
                 groups: dict | None = None,
                 census_rank: int | None = None):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.ranks = None if ranks is None else np.asarray(ranks)
        self.groups = dict(groups or {})
        self.census_rank = census_rank

    @property
    def is_census(self) -> bool:
        """True for a mesh with no process group behind it, whose
        collectives are counted and not sent (:func:`census_mesh`)."""
        return self.census_rank is not None

    @property
    def is_distributed(self) -> bool:
        """True for a mesh over several ranks of a process group."""
        return self.ranks is not None and self.ranks.size > 1

    def coords(self, rank: int | None = None) -> dict[str, int]:
        """Axis name -> the slot index of ``rank`` (default: this
        process's rank, or a census mesh's ``census_rank``) along it; all
        zeros on a mesh of one process."""
        if self.ranks is None:
            return {a: 0 for a in self.axis_names}
        if rank is None:
            rank = self.census_rank if self.is_census else dist.get_rank()
        at = np.argwhere(self.ranks == rank)
        if len(at) != 1:
            raise ValueError(f"rank {rank} is not on mesh {dict(self.shape)}")
        return dict(zip(self.axis_names, (int(i) for i in at[0])))

    def local_device(self) -> torch.device:
        """This process's device: its rank's slot, or the one device of a
        mesh of one process."""
        if self.ranks is None:
            (d,) = self.distinct_devices()
            return d
        return self.devices[tuple(self.coords().values())]

    @property
    def shape(self) -> OrderedDict:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh``)."""
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> list[torch.device]:
        """The mesh's devices, each once, in first-seen order."""
        out = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    slots = np.empty(shape, dtype=object)
    slots.fill(torch.device("meta"))
    return Mesh(slots, axes)


def census_mesh(mesh: Mesh, rank: int = 0) -> Mesh:
    """``mesh``'s shape and slots as a mesh over ranks with no process
    group behind it: slot i (row-major) is rank i, each axis has a
    :class:`CensusGroup` of its size, and ``coords()`` answers for
    ``rank``. Inside ``models.parallel.using`` it the layers take their
    sharded path, and ``models/parallel.py``'s collectives count and
    return tensors of their results' shapes without calling
    ``torch.distributed``: one rank's step, traced on fake tensors at a
    production mesh's size (``launch.specs.rank_traced``)."""
    ranks = np.arange(mesh.size).reshape(mesh.devices.shape)
    groups = {a: CensusGroup(a, n) for a, n in mesh.shape.items()}
    return Mesh(mesh.devices, mesh.axis_names, ranks=ranks, groups=groups,
                census_rank=rank)


def backend_for(devices) -> str:
    """The ``torch.distributed`` backend for ranks on ``devices`` (one
    per rank): ``nccl`` when every rank has a card of its own; ``gloo``
    on the CPU and for ranks that share a card, which NCCL refuses."""
    devices = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devices):
        return "gloo"
    idx = [0 if d.index is None else d.index for d in devices]
    return "nccl" if len(set(idx)) == len(idx) else "gloo"


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` as given (every rank then runs on
    it, e.g. ``cpu``, or ``cuda`` shared by all), else the card of its
    ``LOCAL_RANK``."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def init_distributed(device=None) -> torch.device:
    """Joins the process group that ``torchrun`` (or any launcher setting
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``)
    describes, on the backend :func:`backend_for` picks for this host's
    ranks, and returns this rank's device (:func:`rank_device`)."""
    dev = rank_device(device)
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    host = ([dev] * local if device is not None
            else [torch.device("cuda", i) for i in range(local)])
    backend = backend_for(host)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=world)
    return dev


def _world_mesh(model_parallel: int, device) -> Mesh:
    """The (world // mp, mp) grid of global ranks, row-major: rank r sits
    at (r // mp, r % mp). One ``new_group`` per row ("model") and per
    column ("data"), made by every rank in the same order."""
    world = dist.get_world_size()
    mp = max(1, model_parallel)
    if world % mp:
        raise ValueError(f"--model-parallel {mp} does not divide the "
                         f"{world} ranks")
    ranks = np.arange(world).reshape(world // mp, mp)
    names = [None] * world
    dist.all_gather_object(names, str(device))
    devices = np.empty(ranks.shape, dtype=object)
    for r, name in enumerate(names):
        devices[r // mp, r % mp] = torch.device(name)
    me = dist.get_rank()
    groups = {}
    for axis, lines in (("model", ranks), ("data", ranks.T)):
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if me in line:
                groups[axis] = g
    return Mesh(devices, ("data", "model"), ranks=ranks, groups=groups)


def make_host_mesh(model_parallel: int = 1, devices=None) -> Mesh:
    """Mesh over whatever devices exist (CPU smoke / small runs): every
    CUDA device unless ``devices`` is given (e.g. ``[torch.device("cpu")]``;
    without a GPU the caller must pass them). Under an initialized
    process group of several ranks the mesh spans the world instead: a
    (world // model_parallel, model_parallel) grid of ranks, each slot
    its rank's device (``devices``: this rank's one device, default
    :func:`rank_device`)."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        (device,) = devices if devices is not None else [rank_device()]
        return _world_mesh(model_parallel, torch.device(device))
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices= "
                               "(e.g. [torch.device('cpu')]) for a host mesh "
                               "on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    mp = max(1, min(model_parallel, n))
    devs = np.empty(((n // mp) * mp,), dtype=object)
    devs[:] = devices[: (n // mp) * mp]
    return Mesh(devs.reshape(-1, mp), ("data", "model"))


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def num_batch_shards(mesh) -> int:
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n
