"""Federated partitioning and cohort batch stacking."""
from __future__ import annotations

import numpy as np
import torch


def partition_iid(generator: torch.Generator, dataset: dict,
                  n_clients: int) -> list[dict]:
    """IID split: one permutation, ``np.array_split`` shard sizes (the
    reference's convention). Shards stay on the host."""
    n = dataset["y"].shape[0]
    perm = torch.randperm(n, generator=generator).numpy()
    return [{k: v[torch.from_numpy(s)] for k, v in dataset.items()}
            for s in np.array_split(perm, n_clients)]


def stack_shards(shards: list[dict], device="cpu") -> dict:
    """``[{k: (n_i, ...)}] -> {k: (C, n, ...)}`` on ``device``, ``n`` the
    smallest shard length (longer shards are truncated to it)."""
    n = min(next(iter(s.values())).shape[0] for s in shards)
    return {k: torch.stack([torch.as_tensor(s[k])[:n] for s in shards]).to(device)
            for k in shards[0]}
