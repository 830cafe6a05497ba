"""The paper's experimental model (§6.1): 5-layer MLP, 10 sigmoid neurons
per layer, binary classification over 5 Gaussian features, batch GD.

Parameters travel as a name -> tensor dict in one fixed leaf order,
``layers.0.b, layers.0.w, layers.1.b, ...`` — the order in which the
reference flattens its ``{"layers": [{"w", "b"}]}`` tree (sorted keys).
Specs, aggregation and error feedback all walk the dict in that order.
:class:`MLP` is the module form; :func:`apply` is the functional form
over a dict, which the federated runtime uses with compressed weights.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.layers import dense, init_dense


class Dense(nn.Module):
    def __init__(self, p: dict[str, torch.Tensor]):
        super().__init__()
        self.b = nn.Parameter(p["b"])           # registered first: leaf order
        self.w = nn.Parameter(p["w"])


class MLP(nn.Module):
    def __init__(self, cfg, generator: torch.Generator | None = None,
                 device="cpu"):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        dims = [cfg.num_features] + [cfg.hidden] * cfg.num_layers \
            + [cfg.num_classes]
        # gain 4 compensates sigmoid's max derivative of 1/4
        self.layers = nn.ModuleList(
            Dense(init_dense(generator, i, o, bias=True,
                             scale=4.0 / math.sqrt(i), device=device))
            for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply(dict(self.named_parameters()), x)


def init(generator: torch.Generator, cfg, device="cpu") -> dict:
    return {k: v.detach() for k, v in
            MLP(cfg, generator, device).named_parameters()}


def n_layers(params: dict) -> int:
    return sum(1 for k in params if k.endswith(".w"))


def apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits ``(..., n, classes)``. Params may carry a leading client
    axis that matches x's."""
    h = x
    n = n_layers(params)
    for i in range(n):
        h = dense(params[f"layers.{i}.w"], params[f"layers.{i}.b"], h)
        if i < n - 1:
            h = torch.sigmoid(h)
    return h


def loss_fn(params: dict, batch: dict) -> torch.Tensor:
    """Mean cross-entropy over the sample axis; one value per leading
    (client) index of the batch."""
    logits = apply(params, batch["x"])
    labels = nn.functional.one_hot(batch["y"], logits.shape[-1]).to(
        logits.dtype)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(labels * logp, dim=-1), dim=-1)


def accuracy(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (apply(params, x).argmax(-1) == y).to(torch.float32).mean()
