"""Federated partitioning (IID, and label-skew Dirichlet non-IID) and
cohort batch stacking."""
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


def partition_dirichlet(seed: int, dataset: dict, n_clients: int,
                        alpha: float = 0.5) -> list[dict]:
    """Label-skew non-IID split: per class, shuffle its samples and cut
    them by Dirichlet(alpha) proportions over the clients. The draws come
    from ``np.random.default_rng(seed)`` in the reference's order, so
    the same integer ``seed`` gives the reference's index sets element
    for element (the reference draws ``seed`` from its ``jax.random``
    key). Shards stay on the host; a client may get few or no samples."""
    y = np.asarray(dataset["y"])
    rng = np.random.default_rng(seed)
    idx_per_client: list[list[int]] = [[] for _ in range(n_clients)]
    for c in np.unique(y):
        idx = np.flatnonzero(y == c)
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for ci, part in enumerate(np.split(idx, cuts)):
            idx_per_client[ci].extend(part.tolist())
    out = []
    for ci in range(n_clients):
        sel = torch.tensor(sorted(idx_per_client[ci]), dtype=torch.int64)
        out.append({k: v[sel] for k, v in dataset.items()})
    return out


def stack_shards(shards: list[dict], device="cpu") -> dict:
    """``[{k: (n_i, ...)}] -> {k: (C, n, ...)}`` on ``device``, ``n`` the
    smallest shard length (longer shards are truncated to it)."""
    n = min(next(iter(s.values())).shape[0] for s in shards)
    return {k: torch.stack([torch.as_tensor(s[k])[:n] for s in shards]).to(device)
            for k in shards[0]}
