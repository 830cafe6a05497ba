"""Training entry point for the heterogeneous-FL framework at datacenter
scale: the tier-loop federated train step (paper Fig. 1) over the
synthetic token stream, with AdamW over a warmup-cosine schedule.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --smoke --steps 5 --batch 8 --seq 128 --device cpu

Runs on ``cuda`` unless ``--device`` says otherwise, and raises without
a GPU rather than drop to the CPU. ``--ckpt-dir`` saves the train state
every ``--ckpt-every`` steps and at the end (:class:`Checkpointer`, the
reference's file format) and resumes from the newest checkpoint there.
One card: ``--model-parallel > 1`` (ROADMAP queue 1 item 17,
mesh/sharding) is not ported yet and raises.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.compression import default_tier_plans
from repro_torch.core.scenario import resolve_device
from repro_torch.core.steps import TrainState, make_hetero_train_step
from repro_torch.data.synthetic import make_train_batch
from repro_torch.models import get_model


def train(cfg, *, steps: int = 100, batch: int = 8, seq: int = 128,
          n_tiers: int = 4, lr: float = 3e-4, warmup: int = 20,
          seed: int = 0, device=None, log_every: int = 10,
          ckpt_dir: str = "", ckpt_every: int = 50) -> dict:
    """``steps`` hetero train steps from a random init, or from the
    newest checkpoint in ``ckpt_dir`` (which then gets one every
    ``ckpt_every`` steps and one at the end). Batch ``i`` is a pure
    function of ``(seed, i)``, so a resumed run continues the
    uninterrupted one. Returns the losses of the steps run here (the
    mean over the tiers, and each tier's in plan order), wall seconds
    (each step ends in a device sync), the first step run and the final
    state."""
    device = resolve_device(device)
    shape = ShapeConfig("cli", seq, batch, "train")
    model = get_model(cfg)
    opt = optim.adamw(optim.warmup_cosine(lr, warmup, steps))
    # one card is one data shard: num_groups 1 (the reference's is
    # num_batch_shards(mesh), ROADMAP queue 1 item 17)
    step_fn = make_hetero_train_step(model, opt, default_tier_plans(n_tiers),
                                     num_groups=1)
    state = TrainState.create(model, opt, seed, device=device)
    n_params = sum(x.numel() for x in state["params"].values())
    print(f"arch={cfg.name} params={n_params:,} device={device} "
          f"tiers={n_tiers} use_flash={cfg.use_flash}")
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        state, start = ckpt.restore(state)
        print(f"restored step {start}")
    losses, tier_losses, secs = [], [], []
    for i in range(start, steps):
        b = make_train_batch(cfg, shape, n_tiers=n_tiers, seed=seed, index=i)
        b = {k: v.to(device) for k, v in b.items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        loss = float(metrics["loss"])            # syncs the device
        secs.append(time.perf_counter() - t0)
        losses.append(loss)
        tier_losses.append(metrics["tier_loss"].tolist())
        if (i + 1) % log_every == 0 or i == start:
            dt = sum(secs) / len(secs)
            print(json.dumps({"step": i + 1, "loss": round(loss, 4),
                              "sec_per_step": round(dt, 3),
                              "tokens_per_sec": round(batch * seq / dt)}),
                  flush=True)
        if ckpt is not None and (i + 1) % ckpt_every == 0:
            ckpt.save(state, i + 1)
    if ckpt is not None and ckpt.latest_step() != steps:
        ckpt.save(state, steps)
    return {"losses": losses, "tier_losses": tier_losses,
            "sec_per_step": secs, "start": start, "state": state}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-tiers", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for tests)")
    ap.add_argument("--use-flash", action="store_true",
                    help="attention through the flash_attention kernel")
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError("--model-parallel > 1 is not ported yet: "
                                  "ROADMAP queue 1 item 17 (mesh/sharding)")

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if args.use_flash:
        cfg = cfg.replace(use_flash=True)
    res = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                n_tiers=args.n_tiers, lr=args.lr, warmup=args.warmup,
                seed=args.seed, device=args.device, log_every=args.log_every,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    print("done")
    return res


if __name__ == "__main__":
    main()
