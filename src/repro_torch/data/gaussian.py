"""The paper's dataset (§6.1): 5 Gaussian features, std 1; class 0 mean -1,
class 1 mean +1. Drawn on the CPU from a ``torch.Generator`` (so the
numbers differ from the reference's ``jax.random`` draws by design)."""
from __future__ import annotations

import torch


def make_gaussian_dataset(generator: torch.Generator, n: int,
                          num_features: int = 5, mean: float = 1.0,
                          std: float = 1.0) -> dict:
    y = (torch.rand(n, generator=generator) < 0.5).to(torch.int64)
    mu = torch.where(y[:, None] == 1, mean, -mean)
    x = mu + std * torch.randn((n, num_features), generator=generator)
    return {"x": x.to(torch.float32), "y": y}



def paper_splits(generator: torch.Generator, n_train: int, n_val: int = 1000,
                 n_test: int = 1000, num_features: int = 5):
    """The paper's train / validation / test sets, drawn one after the
    other from ``generator``."""
    return tuple(make_gaussian_dataset(generator, n, num_features)
                 for n in (n_train, n_val, n_test))
