"""Faithful reproduction of the paper's §6 experiments (Figs. 2-4):
5-layer/10-neuron sigmoid MLP, Gaussian binary data, batch GD, 1000
val/test samples, train sizes 500-2000, float64 vs float32.

  PYTHONPATH=src python -m repro_torch.examples.paper_mlp_repro [--device cpu]

The reference prints its float64 row only when JAX runs with x64
enabled; torch needs no such flag, so this port always prints both
dtypes, which is the reference's output under ``JAX_ENABLE_X64=1``.
The splits and init are drawn from ``torch.Generator`` s seeded as the
reference's keys (splits ``seed``, init ``seed + 1``), so the numbers
are the port's own; the reference's data and init can be passed in.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.paper_mlp import config
from repro_torch.core.scenario import resolve_device
from repro_torch.data import paper_splits
from repro_torch.examples import sync
from repro_torch.models import mlp

EPOCHS = 80
SIZES = (500, 1000, 1500, 2000)
DTYPES = (torch.float64, torch.float32)


def train(n_train: int, seed: int = 0, dtype=torch.float32, lr: float = 1.0,
          device=None, data=None, params=None):
    """One full-batch GD step, then ``EPOCHS`` steps, each followed by
    the validation accuracy. ``data`` is a (train, val, test) triple of
    {"x", "y"} and ``params`` the MLP's name -> tensor dict; each is
    drawn from ``seed`` when not given, and both are cast to ``dtype``
    on ``device``. Returns (val accuracies, seconds per epoch, test
    accuracy); the epochs are timed between device syncs."""
    device = resolve_device(device)
    if data is None:
        data = paper_splits(torch.Generator().manual_seed(seed), n_train)
    train_d, val, test = ({"x": d["x"].to(device, dtype),
                           "y": d["y"].to(device)} for d in data)
    if params is None:
        params = mlp.init(torch.Generator().manual_seed(seed + 1), config())
    params = {k: v.to(device, dtype) for k, v in params.items()}

    def step(p):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        g = torch.autograd.grad(mlp.loss_fn(leaves, train_d),
                                list(leaves.values()))
        return {k: v.detach() - lr * gk for (k, v), gk in zip(p.items(), g)}

    params = step(params)
    sync(device)
    accs, t0 = [], time.perf_counter()
    for _ in range(EPOCHS):
        params = step(params)
        accs.append(mlp.accuracy(params, val["x"], val["y"]).item())
    sync(device)
    t_epoch = (time.perf_counter() - t0) / EPOCHS
    test_acc = mlp.accuracy(params, test["x"], test["y"]).item()
    return accs, t_epoch, test_acc


def epochs_to(accs, tgt: float = 0.95):
    return next((i + 1 for i, a in enumerate(accs) if a >= tgt), None)


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def main(argv=None) -> dict:
    """Prints the script's lines; returns {"sizes": {n: (accs, t_epoch,
    test_acc)}, "dtypes": {name: (accs, t_epoch, test_acc)}}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for tests)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {"sizes": {}, "dtypes": {}}
    print("== Fig 2/3: train-set size sweep (float32) ==")
    for n in SIZES:
        accs, t_ep, test_acc = out["sizes"][n] = train(n, device=device)
        print(f"n={n:5d}  max_val_acc={max(accs):.3f}  "
              f"epochs_to_0.95={epochs_to(accs)}  t/epoch={t_ep * 1e3:.2f}ms  "
              f"test_acc={test_acc:.3f}")
    print("== Fig 4: data-type comparison (n=1000) ==")
    for dtype in DTYPES:
        accs, t_ep, _ = out["dtypes"][dtype_name(dtype)] = train(
            1000, dtype=dtype, device=device)
        print(f"{dtype_name(dtype)}:  max_val_acc={max(accs):.3f}  "
              f"epochs_to_0.95={epochs_to(accs)}  t/epoch={t_ep * 1e3:.2f}ms")
    print("(paper: both dtypes reach the same max accuracy; time/memory "
          "differ)")
    return out


if __name__ == "__main__":
    main()
