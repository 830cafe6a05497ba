"""Training entry point for the heterogeneous-FL framework at datacenter
scale: the tier-loop federated train step (paper Fig. 1) over the
synthetic token stream, with AdamW over a warmup-cosine schedule.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --smoke --steps 5 --batch 8 --seq 128 --device cpu

Runs on ``cuda`` unless ``--device`` says otherwise, and raises without
a GPU rather than drop to the CPU. ``--ckpt-dir`` saves the train state
every ``--ckpt-every`` steps and at the end (:class:`Checkpointer`, the
reference's file format) and resumes from the newest checkpoint there.

One process trains on its one device: ``--model-parallel`` builds the
host mesh over that device alone ((1, 1), whatever the flag and however
many cards the host has), takes the batch shards from it and places the
state by ``param_spec_tree`` (``models/sharding.py``). Over several ranks,
one process each (``WORLD_SIZE > 1``)::

  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
      --arch llama3.2-3b --smoke --steps 3 --batch 8 --seq 32 \
      --model-parallel 2 --device cpu

joins the process group (``launch.mesh.init_distributed``: gloo on the
CPU and for ranks that share a card, NCCL for a card per rank, each
rank's card its ``LOCAL_RANK`` unless ``--device`` names one for all),
builds the (world / M, M) mesh of ranks, and places the state by the
reference's ``param_spec_tree(state, mesh.shape["model"])``: each rank
draws the whole state from the seed and keeps its blocks. The step runs
inside ``parallel.using(mesh)``: tensor parallel over "model" (heads,
else head_dim, else d_model; d_ff; the MoE experts; the VLM projector's
columns; the Mamba2 and xLSTM heads, their projections' outputs
gathered where their column blocks do not line up; the vocabulary or
d_model), each "data" rank its rows of the batch (Whisper's frames
too). Rank 0 prints the lines; checkpoints hold whole leaves. Every
family trains so (``--arch xlstm-1.3b``, ``zamba2-2.7b``,
``whisper-tiny`` as the decoders). ``--fsdp`` places the state as the
reference's dry run lays out its train state (``launch/specs.py``'s
``train_setup``): ``param_spec_tree(state, M, fsdp=(("data",), world /
M))``, each leaf's largest dim left after the "model" one split over
"data" too, every leaf gathered where a layer uses it and its gradient
reduce-scattered (``layers.Blocks``). Prefill and decode run over
ranks through ``launch/specs.py``'s ``prefill_setup`` and
``decode_setup`` steps (each rank its blocks of the deployed params and
of the cache); the serve launcher, as the reference's, serves on one
device.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.compression import default_tier_plans
from repro_torch.core.scenario import resolve_device
from repro_torch.core.steps import TrainState, make_hetero_train_step
from repro_torch.data.synthetic import make_train_batch
from repro_torch.launch.mesh import (batch_axes, init_distributed,
                                     make_host_mesh, num_batch_shards)
from repro_torch.models import get_model, parallel
from repro_torch.models.sharding import (named, param_spec_tree, place,
                                         set_rules)


def train(cfg, *, steps: int = 100, batch: int = 8, seq: int = 128,
          n_tiers: int = 4, lr: float = 3e-4, warmup: int = 20,
          seed: int = 0, device=None, log_every: int = 10,
          ckpt_dir: str = "", ckpt_every: int = 50,
          model_parallel: int = 1, fsdp: bool = False) -> dict:
    """``steps`` hetero train steps from a random init, or from the
    newest checkpoint in ``ckpt_dir`` (which then gets one every
    ``ckpt_every`` steps and one at the end). Batch ``i`` is a pure
    function of ``(seed, i)``, so a resumed run continues the
    uninterrupted one. In one process the mesh is the host's
    (``model_parallel`` model shards a row) over ``device`` alone; with
    ``WORLD_SIZE > 1`` in the environment (``torchrun``) it is the mesh
    of the world's ranks (module docstring); ``fsdp`` splits the state
    over the data axes too. Returns the losses of the steps run here
    (the mean over the tiers, and each tier's in plan order), wall
    seconds (each step ends in a device sync), on a card each step's
    ``max_memory_allocated`` (its peak statistics reset just before the
    step), the first step run, the final state (this rank's blocks) and
    its shardings."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = init_distributed(device)
    else:
        device = resolve_device(device)
    shape = ShapeConfig("cli", seq, batch, "train")
    mesh = make_host_mesh(model_parallel, devices=[device])
    lead = not mesh.is_distributed or dist.get_rank() == 0
    set_rules({})
    model = get_model(cfg)
    opt = optim.adamw(optim.warmup_cosine(lr, warmup, steps))
    state = TrainState.create(model, opt, seed, device=device)
    n_params = sum(x.numel() for x in state["params"].values())
    if lead:
        print(f"arch={cfg.name} params={n_params:,} mesh={dict(mesh.shape)} "
              f"device={device} tiers={n_tiers} use_flash={cfg.use_flash}"
              + (" fsdp" if fsdp else ""))
    state_sh = named(mesh, param_spec_tree(
        state, mesh.shape["model"],
        (batch_axes(mesh), num_batch_shards(mesh)) if fsdp else None))
    state = place(state, state_sh)
    # over ranks the compression and the checkpoints need the layouts
    ranks_sh = state_sh if mesh.is_distributed else None
    step_fn = make_hetero_train_step(
        model, opt, default_tier_plans(n_tiers),
        num_groups=num_batch_shards(mesh),
        shardings=None if ranks_sh is None else ranks_sh["params"])
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        state, start = ckpt.restore(state, shardings=ranks_sh)
        if lead:
            print(f"restored step {start}")
    losses, tier_losses, secs, peaks = [], [], [], []
    card = torch.device(device).type == "cuda"
    with parallel.using(mesh):
        for i in range(start, steps):
            b = make_train_batch(cfg, shape, n_tiers=n_tiers, seed=seed,
                                 index=i)
            b = {k: v.to(device) for k, v in b.items()}
            if card:
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, b)
            loss = float(metrics["loss"])            # syncs the device
            secs.append(time.perf_counter() - t0)
            if card:
                peaks.append(torch.cuda.max_memory_allocated(device))
            losses.append(loss)
            tier_losses.append(metrics["tier_loss"].tolist())
            if lead and ((i + 1) % log_every == 0 or i == start):
                dt = sum(secs) / len(secs)
                print(json.dumps({"step": i + 1, "loss": round(loss, 4),
                                  "sec_per_step": round(dt, 3),
                                  "tokens_per_sec": round(batch * seq / dt)}),
                      flush=True)
            if ckpt is not None and (i + 1) % ckpt_every == 0:
                ckpt.save(state, i + 1, shardings=ranks_sh)
    if ckpt is not None and ckpt.latest_step() != steps:
        ckpt.save(state, steps, shardings=ranks_sh)
    return {"losses": losses, "tier_losses": tier_losses,
            "sec_per_step": secs, "peak_bytes": peaks, "start": start,
            "state": state, "shardings": state_sh}


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
    ap.add_argument("--fsdp", action="store_true",
                    help="split the train state over the data axes too")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for tests)")
    ap.add_argument("--use-flash", action="store_true",
                    help="attention through the flash_attention kernel")
    args = ap.parse_args(argv)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if args.use_flash:
        cfg = cfg.replace(use_flash=True)
    res = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                n_tiers=args.n_tiers, lr=args.lr, warmup=args.warmup,
                seed=args.seed, device=args.device, log_every=args.log_every,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                model_parallel=args.model_parallel, fsdp=args.fsdp)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print("done")
    if dist.is_initialized():
        dist.destroy_process_group()
    return res


if __name__ == "__main__":
    main()
