"""Which ``torch.distributed`` collectives the gloo backend takes on a
device's tensors, and at what rate: two ranks on one device (the way
``chip_smoke.py``'s phase mesh shares its one card).

  PYTHONPATH=src python -m repro_torch.launch.probe_collectives --device cuda

Rank 0 prints, per dtype, whether all_reduce (SUM, MAX), broadcast,
all_gather, all_gather_into_tensor, reduce_scatter and
reduce_scatter_tensor ran, then the mean time of a one-element f32
all_reduce (200 calls) and of an f32 all_reduce, all_gather_into_tensor
and reduce_scatter_tensor of 805 MB (the whole tensor; 3 calls each),
each after a warm-up. The ranks meet on a free port of 127.0.0.1.
"""
from __future__ import annotations

import argparse
import socket
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DTYPES = (torch.float32, torch.bfloat16, torch.int64, torch.float16)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _collectives(world: int) -> dict:
    return {
        "all_reduce_sum": lambda x: dist.all_reduce(x),
        "all_reduce_max": lambda x: dist.all_reduce(x, op=dist.ReduceOp.MAX),
        "broadcast": lambda x: dist.broadcast(x, 0),
        "all_gather": lambda x: dist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x),
        "all_gather_into_tensor": lambda x: dist.all_gather_into_tensor(
            torch.empty((world * x.numel(),), dtype=x.dtype,
                        device=x.device), x),
        "reduce_scatter": lambda x: dist.reduce_scatter(
            torch.empty_like(x), [x.clone() for _ in range(world)]),
        "reduce_scatter_tensor": lambda x: dist.reduce_scatter_tensor(
            torch.empty((x.numel() // world,), dtype=x.dtype,
                        device=x.device), x),
    }


def _ms_per_call(fn, device, calls: int) -> float:
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3 / calls


def _rank(rank: int, world: int, port: int, device: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    d = torch.device(device)
    lines = []
    try:
        for dt in DTYPES:
            for name, fn in _collectives(world).items():
                x = torch.full((8,), rank + 1, dtype=dt, device=d)
                try:
                    fn(x)
                    _sync(d)
                    lines.append(f"{name} {dt} ok")
                except RuntimeError as e:
                    lines.append(f"{name} {dt} refused: {str(e)[:120]}")
        one = torch.ones((), device=d)
        big = torch.ones((64, 1024, 3072), device=d)
        lines.append(f"one-element f32 all_reduce "
                     f"{_ms_per_call(lambda: dist.all_reduce(one), d, 200):.3f}"
                     f" ms")
        part = torch.ones((big.numel() // world,), device=d)
        for name, fn in (
                ("all_reduce", lambda: dist.all_reduce(big)),
                ("all_gather_into_tensor",
                 lambda: dist.all_gather_into_tensor(big.view(-1), part)),
                ("reduce_scatter_tensor",
                 lambda: dist.reduce_scatter_tensor(part, big.view(-1)))):
            ms = _ms_per_call(fn, d, 3)
            lines.append(f"{big.numel() * 4 / 1e6:.0f} MB f32 {name} "
                         f"{ms:.1f} ms ({big.numel() * 4 / ms / 1e6:.3f} "
                         f"GB/s)")
        if rank == 0:
            print("\n".join(lines), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args(argv)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {args.device} ranks {args.ranks}")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(_rank, args=(args.ranks, port, args.device),
                       nprocs=args.ranks, start_method="spawn")


if __name__ == "__main__":
    main()
