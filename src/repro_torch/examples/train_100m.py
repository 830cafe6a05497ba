"""End-to-end training run: a llama-style model of ~81M parameters
(12 layers, d_model 512, ffn 2048, vocab 32768, GQA 8/4, f32) trained
with the heterogeneous federated step for a few hundred rounds.

Default flags are the real run (300 steps, batch 8 x seq 512, 4 tiers).
Use --steps/--batch/--seq to scale down for a quick look:

  PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 5 \\
      --batch 4 --seq 128 [--device cpu]

The reference's docstring calls this model ~115M; its params line, like
this one, prints the count of the config's leaves: 80,753,152 (80.8M).
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.core.compression import default_tier_plans
from repro_torch.core.scenario import resolve_device
from repro_torch.core.steps import TrainState, make_hetero_train_step
from repro_torch.data.synthetic import TokenStream
from repro_torch.examples import sync
from repro_torch.models import get_model

CKPT_EVERY = 100


def config_100m() -> ModelConfig:
    # 12L x d512 x ffn2048, 32k vocab (llama-style, GQA 8/4)
    return ModelConfig(
        name="llama-100m", family="dense", num_layers=12, d_model=512,
        num_heads=8, num_kv_heads=4, d_ff=2048, vocab_size=32768,
        dtype="float32")


def train(cfg: ModelConfig, *, steps: int = 300, batch: int = 8,
          seq: int = 512, n_tiers: int = 4, ckpt_dir: str = "", device=None,
          state: dict | None = None) -> dict:
    """``steps`` hetero train steps under AdamW(warmup_cosine(3e-4, 30,
    steps)) over ``default_tier_plans(n_tiers)``, on the token stream's
    batches reshaped to (n_tiers, batch / n_tiers, seq + 1), from
    ``state`` or from init seed 0. Prints the script's params line and
    JSON log lines; saves the state every ``CKPT_EVERY`` steps into
    ``ckpt_dir`` when one is given. Returns the params count, each
    step's loss and wall seconds (each step ends in a device sync) and
    the final state."""
    device = resolve_device(device)
    model = get_model(cfg)
    opt = optim.adamw(optim.warmup_cosine(3e-4, 30, steps))
    step = make_hetero_train_step(model, opt, default_tier_plans(n_tiers))
    if state is None:
        state = TrainState.create(model, opt, 0, device=device)
    n = sum(x.numel() for x in state["params"].values())
    print(f"params: {n / 1e6:.1f}M, tiers: {n_tiers}, "
          f"tokens/step: {batch * seq}")

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    stream = TokenStream(cfg.vocab_size, batch, seq)
    per = batch // n_tiers
    losses, secs = [], []
    t0 = time.time()
    for i, b in zip(range(steps), stream):
        tiered = {"tokens": b["tokens"].reshape(n_tiers, per, -1).to(device)}
        sync(device)
        t_step = time.perf_counter()
        state, m = step(state, tiered)
        losses.append(m["loss"].item())          # syncs the device
        secs.append(time.perf_counter() - t_step)
        if (i + 1) % max(steps // 20, 1) == 0 or i == 0:
            print(json.dumps({"step": i + 1, "loss": round(losses[-1], 4),
                              "elapsed_s": round(time.time() - t0, 1)}),
                  flush=True)
        if ckpt and (i + 1) % CKPT_EVERY == 0:
            ckpt.save(state, i + 1)
    print("done")
    return {"params": n, "losses": losses, "sec_per_step": secs,
            "state": state}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--n-tiers", type=int, default=4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for tests)")
    args = ap.parse_args(argv)
    return train(config_100m(), steps=args.steps, batch=args.batch,
                 seq=args.seq, n_tiers=args.n_tiers, ckpt_dir=args.ckpt_dir,
                 device=args.device)


if __name__ == "__main__":
    main()
