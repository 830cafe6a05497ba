"""Minimal dependency-free checkpointer for nested dicts / lists / tuples
of tensors: the reference's file format, so either package reads the
other's files.

Leaves go into one ``.npz`` under keys ``a0, a1, ...`` with a JSON
``__meta__`` entry naming each (``{"name": ..., "dtype": ...}``);
bfloat16 is stored as its uint16 bits. A leaf's name is its path joined
with ``/``, with every dict key split at ``.``: the port's MLP weight,
key ``layers.0.w`` of the params dict, is ``params/layers/0/w``, the
reference's name for the same leaf of its ``{"layers": [{"w", ...}]}``
tree. Writes are atomic (temp file, then rename); :class:`Checkpointer`
keeps the last ``keep`` steps. Given the state's shardings over a mesh of
several ranks, :class:`Checkpointer` writes whole leaves (gathered, rank
0 writes, the others wait) and restores each rank's blocks, so one file
crosses between 1 rank, N ranks and the reference.
"""
from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np
import torch
import torch.distributed as dist


def map_named(fn, tree, prefix: tuple = (), is_leaf=None):
    """``tree`` with each leaf replaced by ``fn(name, leaf)``, where a
    leaf's name is the checkpoint's (its path joined with ``/``, every
    dict key split at ``.``). Dicts, lists and tuples are containers,
    unless ``is_leaf`` says otherwise."""
    if is_leaf is not None and is_leaf(tree):
        return fn("/".join(prefix), tree)
    if isinstance(tree, dict):
        return {k: map_named(fn, v, prefix + tuple(str(k).split(".")),
                             is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_named(fn, v, prefix + (str(i),), is_leaf)
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn("/".join(prefix), tree)


def named_leaves(tree) -> list[tuple[str, object]]:
    """``(name, tensor)`` pairs in container order; empty containers have
    none."""
    out = []
    map_named(lambda name, leaf: out.append((name, leaf)), tree)
    return out


def save_pytree(tree, path: str) -> None:
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    arrays, meta = {}, {}
    for i, (name, leaf) in enumerate(named_leaves(tree)):
        key = f"a{i}"
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            arrays[key] = t.view(torch.int16).numpy().view(np.uint16)
            meta[key] = {"name": name, "dtype": "bfloat16"}
        else:
            arrays[key] = t.numpy()
            meta[key] = {"name": name, "dtype": str(arrays[key].dtype)}
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz")
    os.close(fd)
    try:
        np.savez(tmp, __meta__=np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8), **arrays)
        os.replace(tmp, path)
    except BaseException:
        os.remove(tmp)
        raise


def _whole(name: str, by_name: dict) -> torch.Tensor:
    if name not in by_name:
        raise KeyError(f"checkpoint missing leaf {name!r}")
    a, dtype = by_name[name]
    return (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            if dtype == "bfloat16" else torch.from_numpy(a))


def _check_shape(name: str, t, tmpl):
    if tuple(t.shape) != tuple(tmpl.shape):
        raise ValueError(f"shape mismatch for {name}: {tuple(t.shape)} vs "
                         f"{tuple(tmpl.shape)}")
    return t


def load_pytree(template, path: str, shardings=None):
    """Restore into the structure of ``template`` (names must match; each
    tensor leaf lands on its template's device in the saved dtype). With
    ``shardings`` (``models.sharding.place``'s) each whole leaf is placed
    by its sharding: on a mesh of several ranks, this rank's block, which
    must have the template's shape."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        by_name = {m["name"]: (z[key], m["dtype"]) for key, m in meta.items()}
    if shardings is None:
        return map_named(lambda name, t: _check_shape(
            name, _whole(name, by_name), t).to(t.device), template)
    from repro_torch.models.sharding import place   # it imports this module
    placed = place(map_named(lambda name, t: _whole(name, by_name), template),
                   shardings)
    shapes = dict(named_leaves(template))
    return map_named(lambda name, t: _check_shape(name, t, shapes[name]),
                     placed)


def _ranks(shardings):
    """The mesh of several ranks that ``shardings`` place over, or None."""
    found = []
    map_named(lambda _, s: found.append(s), shardings,
              is_leaf=lambda x: x is None or hasattr(x, "mesh"))
    return next((s.mesh for s in found
                 if s is not None and s.mesh.is_distributed), None)


class Checkpointer:
    """Numbered checkpoints ``ckpt_{step:08d}.npz`` in one directory,
    keeping the newest ``keep``."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def _steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.dir)
                      if (m := re.match(r"ckpt_(\d+)\.npz$", f)))

    def save(self, tree, step: int, shardings=None) -> str:
        """``shardings``: the tree's (``models.sharding.place``'s); over a
        mesh of several ranks every rank must call this: the leaves are
        gathered whole, rank 0 writes, and all wait for it."""
        p = self._path(step)
        mesh = None if shardings is None else _ranks(shardings)
        if mesh is not None:
            from repro_torch.models.sharding import gather
            tree = gather(tree, shardings)
        if mesh is None or dist.get_rank() == 0:
            save_pytree(tree, p)
            for s in self._steps()[:-self.keep]:
                os.remove(self._path(s))
        if mesh is not None:
            dist.barrier()
        return p

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None, shardings=None):
        """``shardings``: as :func:`load_pytree`'s (each rank keeps its
        blocks of the whole leaves)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return load_pytree(template, self._path(step), shardings), step
