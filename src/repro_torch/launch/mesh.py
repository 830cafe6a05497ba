"""Device meshes, as the reference's ``launch/mesh.py``.

A :class:`Mesh` is a numpy object array of ``torch.device`` slots with
one name per axis. The production meshes are the reference's TPU v5e
grids (one pod = 16 x 16 = 256 chips; two pods add a ``"pod"`` axis) as
abstract ``meta`` slots: the dry run shards shapes over them and places
nothing. The host mesh covers the devices that exist.

Defined as functions, so importing this module touches no device.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


class Mesh:
    """``devices``: an object array of ``torch.device``; ``axis_names``:
    one name per axis of it."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

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


def make_host_mesh(model_parallel: int = 1, devices=None) -> Mesh:
    """Mesh over whatever devices exist (CPU smoke / small runs): every
    CUDA device unless ``devices`` is given (e.g. ``[torch.device("cpu")]``;
    without a GPU the caller must pass them)."""
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
