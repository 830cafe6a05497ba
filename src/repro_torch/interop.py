"""Carry weights and data between the reference's nested trees and the
port's name -> tensor dicts, through numpy.

A reference tree such as ``{"layers": [{"w": ..., "b": ...}, ...]}``
(dicts and lists of numpy arrays, e.g. ``jax.tree.map(np.asarray, p)``)
maps to leaves named by their path, ``layers.0.b``, ``layers.0.w``, ...:
dict keys sorted and list positions in order — the reference's flatten
order, which the port uses everywhere. Leaves are matched by name, so a
tree and a dict with the same paths round-trip whatever order their
containers were built in.
"""
from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def params_from_numpy(tree, device="cpu") -> dict[str, torch.Tensor]:
    """Nested dicts/lists of arrays -> name -> f32 tensor on ``device``."""
    flat: dict = {}
    _flatten(tree, "", flat)
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in flat.items()}


def params_to_numpy(params: dict[str, torch.Tensor]):
    """name -> tensor -> the nested dicts/lists of numpy arrays the
    reference uses (an all-digit path segment indexes a list)."""
    root: dict = {}
    for name, v in params.items():
        node, parts = root, name.split(".")
        for part, nxt in zip(parts[:-1], parts[1:]):
            node = _child(node, part, [] if nxt.isdigit() else {})
        _child(node, parts[-1], None, v.detach().cpu().numpy())
    return root


def _child(node, key: str, empty, value=None):
    """``node[key]``, created as ``empty`` if missing, or set to
    ``value`` when one is given."""
    if isinstance(node, list):
        i = int(key)
        node.extend([None] * (i + 1 - len(node)))
        if value is not None or node[i] is None:
            node[i] = value if value is not None else empty
        return node[i]
    if value is not None:
        node[key] = value
    return node.setdefault(key, empty)


def shards_from_numpy(shards: list[dict]) -> list[dict]:
    """Client shards ``[{"x": (n, F), "y": (n,)}]`` as host tensors
    (features f32, labels int64)."""
    return [{"x": torch.tensor(np.asarray(s["x"], np.float32)),
             "y": torch.tensor(np.asarray(s["y"]).astype(np.int64))}
            for s in shards]
