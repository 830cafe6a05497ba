"""Time an FL round's aggregation step, and ablate the grouped kernel's
launch, on the card.

    PYTHONPATH=src python src/repro_torch/kernels/fleet_aggregate/bench.py
    PYTHONPATH=src python src/repro_torch/kernels/fleet_aggregate/bench.py --pdl

Without options: the reference's one-leaf APIs at the paper MLP's
(10, 10) leaf, T = 4 (CUDA-event ms per call); then, for the 256-client
bench fleets of ``chip_smoke.py``
(masked and width, hub/high/mid/low; fedavg_fp8_ef, six tiers), one
real round's cohort updates and masks as ``ScanEngine`` hands them to
its aggregation, then the engine's fused aggregation
(``_aggregate_fused``) and its sequential chain, each timed with CUDA
events (median of 15 windows of 20 calls), with the device time and
device ops of one fused call from the profiler; then ms per round of 20
``scan_pallas`` rounds. It uses only what every version of the port's
engine has, so it measures whichever ``repro_torch`` is on the path:
run it once with ``PYTHONPATH`` at an older checkout's ``src`` and once
at this one, in turns, to compare them on one card in one run.

``--pdl``: builds ``csrc/fleet_aggregate.cu`` as it is and a copy that
launches with programmatic dependent launch (``cudaLaunchKernelEx``
with programmatic stream serialization; ``griddepcontrol.wait`` first
in the kernel) and times each, in the order kernel, pdl, pdl, kernel,
on the paper MLP's masked round: the grouped call alone, and behind a
PyTorch kernel of ~10 us, the case where the launch could overlap.
The copy exists only to measure.
Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import types

import torch

ROUNDS = 20
BENCH_TIERS = ("hub", "high", "mid", "low")
QUICKSTART_TIERS = ("hub", "high", "mid", "mid", "low", "embedded")


def time_ms(fn, reps: int = 15, inner: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_profile(fn, calls: int = 100) -> tuple[float, float]:
    """(device ms, device ops) per call of ``fn``, from the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return (sum(e.time_range.elapsed_us() for e in ev) / calls / 1e3,
            len(ev) / calls)


def scenarios() -> dict:
    from repro_torch.fl import (FleetSpec, FLScenario, LocalTraining,
                                UploadPolicy)
    fleet = FleetSpec.cycling(BENCH_TIERS, 256, samples_per_client=16)
    return {
        "masked": FLScenario(fleet=fleet),
        "width": FLScenario(fleet=fleet,
                            local=LocalTraining(submodel="width")),
        "fedavg_fp8_ef": FLScenario(
            fleet=FleetSpec.cycling(QUICKSTART_TIERS, 256,
                                    samples_per_client=16),
            local=LocalTraining(mode="fedavg"),
            upload=UploadPolicy(quant="fp8_e4m3", error_feedback=True))}


def real_round(scenario):
    """(engine, params, per_cohort) of one scan_pallas round on the card."""
    from repro_torch import optim
    from repro_torch.configs.paper_mlp import config
    from repro_torch.fl import ScanEngine, build_server
    from repro_torch.models import mlp
    srv = build_server(scenario, types.SimpleNamespace(loss_fn=mlp.loss_fn),
                       optim.sgd(1.0),
                       mlp.init(torch.Generator().manual_seed(0), config()),
                       device=torch.device("cuda"))
    eng = ScanEngine(srv, agg="pallas")
    seen = []
    fused = eng._aggregate_fused
    eng._aggregate_fused = lambda p, pc: seen.append((p, pc)) or fused(p, pc)
    eng.run(1)
    del eng._aggregate_fused
    return eng, seen[0][0], seen[0][1]


def one_leaf() -> None:
    """The reference's one-leaf APIs at the paper MLP's (10, 10) leaf,
    T = 4: grad_aggregate over (4, 100), structured_scatter_batched over
    the four hidden layers' width-sliced tiers."""
    from repro_torch.kernels.grad_aggregate import grad_aggregate
    from repro_torch.kernels.structured_scatter import (
        structured_scatter_batched)
    import repro_torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    w, wd = [1.0] * 4, [64.0, 64.0, 0.0, 64.0]
    g = torch.randn((4, 100), generator=gen, device="cuda")
    m = (torch.rand((4, 100), generator=gen, device="cuda") < 0.6).float()
    locs = [(10, 10), (10, 10), (5, 5), (3, 3)]
    gs = [torch.randn((4,) + s, generator=gen, device="cuda") for s in locs]
    ms = [(torch.rand((4,) + s, generator=gen, device="cuda") < 0.7).float()
          for s in locs]
    print(json.dumps({
        "bench": "one_leaf", "package": repro_torch.__file__,
        "grad_aggregate_ms": time_ms(
            lambda: grad_aggregate(g, m, w, w_den=wd)),
        "structured_scatter_batched_ms": time_ms(
            lambda: structured_scatter_batched(gs, ms, w, wd,
                                               out_shape=(10, 10)))}))


def steps() -> None:
    from repro_torch.fl import simulate
    import repro_torch
    one_leaf()
    for label, sc in scenarios().items():
        eng, params, pc = real_round(sc)
        got = eng._aggregate_fused(params, pc)
        want = eng._aggregate_sequential(params, pc)
        bitwise = all(torch.equal(got[k], want[k]) for k in params)
        fused_ms = time_ms(lambda: eng._aggregate_fused(params, pc))
        chain_ms = time_ms(lambda: eng._aggregate_sequential(params, pc))
        dev_ms, ops = device_profile(lambda: eng._aggregate_fused(params, pc))
        simulate(sc, 2, engine="scan_pallas", device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        simulate(sc, ROUNDS, engine="scan_pallas", device="cuda")
        torch.cuda.synchronize()
        round_ms = (time.perf_counter() - t0) / ROUNDS * 1e3
        print(json.dumps({
            "bench": "aggregation_step", "fleet": label,
            "package": repro_torch.__file__, "leaves": len(params),
            "tiers": len(pc), "fused_ms": fused_ms,
            "fused_device_ms": dev_ms, "fused_device_ops": ops,
            "chain_ms": chain_ms, "fused_bitwise_chain": bitwise,
            "scan_pallas_ms_per_round": round_ms}))


def _pdl_source(src: str) -> str:
    head = "fleet_aggregate_kernel(const __grid_constant__ FleetArgs a) {"
    launch = ("  fleet_aggregate_kernel<<<grid, THREADS, 0, "
              "(cudaStream_t)stream>>>(*a);")
    out = src.replace(head, head + '\n  asm volatile("griddepcontrol.wait;" '
                                   '::: "memory");')
    out = out.replace(launch, """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fleet_aggregate_kernel, *a);
  if (e != cudaSuccess) return (int)e;""")
    if out.count("griddepcontrol") != 1 or "cudaLaunchKernelEx" not in out:
        raise RuntimeError("the pdl substitution no longer matches "
                           "csrc/fleet_aggregate.cu")
    return out


def pdl() -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels.fleet_aggregate import fleet_aggregate
    from repro_torch.kernels.fleet_aggregate import ops
    src = (build.CSRC / "fleet_aggregate.cu").read_text()
    libs = build.build_variants("fleet_aggregate",
                                {"kernel": src, "pdl": _pdl_source(src)})
    launchers = {k: ops._Launcher(lib) for k, lib in libs.items()}
    _, params, pc = real_round(scenarios()["masked"])
    leaves = {k: (p.shape, [(g[k], m[k]) for (g, m, _, _) in pc])
              for k, p in params.items()}
    wn = [1.0] * len(pc)
    wd = [64.0] * len(pc)
    busy = torch.zeros(1 << 22, device="cuda")
    for name in ("kernel", "pdl", "pdl", "kernel"):
        ops._launcher = lambda L=launchers[name]: L
        out = fleet_aggregate(leaves, wn, wd)
        ref = fleet_aggregate({k: (s, [(g.cpu(), m.cpu()) for g, m in t])
                               for k, (s, t) in leaves.items()}, wn, wd)
        same = all(torch.equal(out[k].cpu(), ref[k]) for k in leaves)
        alone = time_ms(lambda: fleet_aggregate(leaves, wn, wd))
        behind = time_ms(lambda: (busy.mul_(1.0),
                                  fleet_aggregate(leaves, wn, wd)))
        busy_ms = time_ms(lambda: busy.mul_(1.0))
        print(json.dumps({"bench": "pdl", "variant": name,
                          "bitwise_plain": same, "alone_ms": alone,
                          "behind_mul_ms": behind, "mul_alone_ms": busy_ms}))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    if "--pdl" in sys.argv[1:]:
        pdl()
    else:
        steps()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
