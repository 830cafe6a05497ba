"""Functional optimizers over name -> tensor dicts: SGD, momentum, Adam,
AdamW. The same ``init``/``update`` pair as the reference, not
``torch.optim``:  opt = sgd(lr);  state = opt.init(params);
                  params, state = opt.update(grads, state, params, step=...)
Scalars enter the f32 arithmetic as f32, as JAX's weak types do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


def _lr_at(lr, step):
    return lr(step) if callable(lr) else lr


def sgd(lr) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, step=0):
        lr_t = _lr_at(lr, step)
        return {k: p - lr_t * grads[k] for k, p in params.items()}, state

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9) -> Optimizer:
    def init(params):
        return {"m": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params, step=0):
        lr_t = _lr_at(lr, step)
        m = {k: beta * state["m"][k] + grads[k] for k in params}
        return {k: p - lr_t * m[k] for k, p in params.items()}, {"m": m}

    return Optimizer(init, update)


def _adam_core(lr, b1, b2, eps, wd):
    def init(params):
        dev = next(iter(params.values())).device
        return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
                "v": {k: torch.zeros_like(p) for k, p in params.items()},
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, step=None):
        count = state["count"] + 1
        lr_t = _lr_at(lr, count if step is None else step)
        m = {k: b1 * state["m"][k] + (1 - b1) * grads[k] for k in params}
        v = {k: b2 * state["v"][k] + (1 - b2) * grads[k] * grads[k]
             for k in params}
        c = count.to(torch.float32)
        bc1 = 1 - torch.full_like(c, b1) ** c
        bc2 = 1 - torch.full_like(c, b2) ** c

        def upd(p, m, v):
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if wd:
                u = u + wd * p
            return p - lr_t * u

        return ({k: upd(p, m[k], v[k]) for k, p in params.items()},
                {"m": m, "v": v, "count": count})

    return Optimizer(init, update)


def adam(lr, b1=0.9, b2=0.999, eps=1e-8) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, 0.0)


def adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay)
