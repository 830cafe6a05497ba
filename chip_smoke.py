"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and prints the compiler's resource
   report.
2. Phase "kernels": calls every kernel of the FL round's path at the
   shapes that path gives it (the paper MLP, the 256-wide width-fleet
   MLP, a ragged size, scalar masks) and holds it against its plain
   PyTorch version on the card — structured_scatter bitwise,
   grad_aggregate bitwise against the port's accumulate_cohort ->
   finalize chain and to atol 1e-6 against its plain version — then
   times kernel and plain version with CUDA events (median) beside the
   bound (bytes / 3.35 TB/s).
3. Phase "slice": ``simulate`` on the card at the 256-client bench fleet,
   20 rounds each: the masked fleet (eager, scan, scan_pallas), its
   width-sliced twin (scan, scan_pallas) and FedAvg with fp8 uploads and
   error feedback on the six-tier quickstart fleet (scan, scan_pallas).
   Launch counters are zeroed just before each scan_pallas run and read
   just after; scan_pallas must equal scan bitwise on the masked and
   width fleets; losses must be finite and fall; a small run must agree
   with the port's CPU path.

Prints the card's name and power limit, per-kernel times, launches per
round and ms per round, then the kernels JSON line and, last, the
``{"ok": true, ...}`` line. Any failed check exits non-zero. Needs a
CUDA GPU and the repository's ``src/`` beside this file; exits non-zero
without either.
"""
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
ROUNDS = 20
BENCH_TIERS = ("hub", "high", "mid", "low")
QUICKSTART_TIERS = ("hub", "high", "mid", "mid", "low", "embedded")


class CheckFailed(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)
    print(f"check ok: {what}")


def time_ms(fn, reps: int = 15, inner: int = 20) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` calls each."""
    import torch
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


def bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def device_events(prof) -> list:
    """The device-side events (kernels, copies) of a profiler trace."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def kernel_device_ms(fn, kernel: str, calls: int = 200):
    """Mean device time of ``kernel`` over ``calls`` calls of ``fn``, from
    the profiler's device trace (None if the trace has no such kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in device_events(prof) if kernel in e.name]
    return (sum(e.time_range.elapsed_us() for e in ev) / len(ev) / 1e3
            if ev else None)


# ------------------------------------------------------------- kernels

def _mlp_params(cfg, device):
    import torch
    from repro_torch.models import mlp
    return mlp.init(torch.Generator().manual_seed(0), cfg, device)


def _grad_cases(device):
    """(label, g (T,N), m (T,N) or (T,1)) at the masked path's shapes:
    every >=2-D leaf of the paper MLP and of the wide MLP, T = 4, plus a
    ragged size and scalar masks."""
    import torch
    from repro_torch.configs.paper_mlp import MLPConfig, config
    gen = torch.Generator().manual_seed(1)
    cases = []
    for tag, cfg in (("paper", config()),
                     ("wide", MLPConfig(hidden=256, num_layers=4))):
        seen = set()
        for k, p in _mlp_params(cfg, "cpu").items():
            if p.dim() < 2 or tuple(p.shape) in seen:
                continue
            seen.add(tuple(p.shape))
            n = p.numel()
            g = torch.randn((4, n), generator=gen)
            m = (torch.rand((4, n), generator=gen) < 0.6).float()
            m[0] = 1.0                                   # the hub keeps all
            cases.append((f"{tag}{tuple(p.shape)}", g, m))
    g = torch.randn((4, 1001), generator=gen)
    cases.append(("ragged(1001,)", g,
                  (torch.rand((4, 1001), generator=gen) < 0.5).float()))
    cases.append(("scalar_mask(1001,)", g,
                  torch.tensor([[1.0], [0.0], [1.0], [1.0]])))
    return [(lbl, g.to(device), m.to(device)) for lbl, g, m in cases]


def _scatter_cases(device):
    """(label, gs, ms, out_shape) per same-signature leaf group of the
    paper MLP's and the wide MLP's width fleet (tiers hub/high/mid/low =
    widths 1, 1, 0.5, 0.25), as the engine batches them."""
    import torch
    from repro_torch.configs.paper_mlp import MLPConfig, config
    from repro_torch.core.compression import DEVICE_TIERS, submodel_spec
    gen = torch.Generator().manual_seed(2)
    cases = []
    for tag, cfg in (("paper", config()),
                     ("wide", MLPConfig(hidden=256, num_layers=4))):
        params = _mlp_params(cfg, "cpu")
        specs = [submodel_spec(params, DEVICE_TIERS[t].as_width_sliced().width)
                 for t in BENCH_TIERS]
        groups: dict = {}
        for i, (k, p) in enumerate(params.items()):
            sig = (tuple(p.shape), tuple(s.local_shape(i) for s in specs))
            groups.setdefault(sig, []).append(k)
        for (shape, locals_), ks in groups.items():
            L = len(ks)
            gs = [torch.randn((L,) + loc, generator=gen) for loc in locals_]
            if len(shape) == 1:                  # biases: scalar masks
                ms = [torch.ones(L) for _ in locals_]
            else:
                ms = [(torch.rand((L,) + loc, generator=gen) < 0.7).float()
                      for loc in locals_]
            cases.append((f"{tag}{shape}x{L}", [g.to(device) for g in gs],
                          [m.to(device) for m in ms], shape))
    return cases


def phase_kernels(device) -> dict:
    import torch
    from repro_torch.core.aggregation import accumulate_cohort, f32, finalize
    from repro_torch.kernels.grad_aggregate import grad_aggregate
    from repro_torch.kernels.grad_aggregate.ref import grad_aggregate_ref
    from repro_torch.kernels.structured_scatter import (
        structured_scatter_batched)
    from repro_torch.kernels.structured_scatter.ref import (
        leaf_views, scatter_views_ref)
    w = [1.0, 1.0, 1.0, 1.0]
    counts = [64.0, 64.0, 0.0, 64.0]
    wd = [f32(f32(a) * f32(c)) for a, c in zip(w, counts)]
    rows = {}

    err = 0.0
    for lbl, g, m in _grad_cases(device):
        out = grad_aggregate(g, m, w, w_den=wd)
        plain = grad_aggregate_ref(g, m, w, wd)
        acc = ({"x": torch.zeros_like(out)},
               {"x": torch.zeros_like(out)})
        for t in range(4):
            acc = accumulate_cohort(acc, {"x": g[t]},
                                    {"x": m[t] if m.shape[1] > 1 else m[t, 0]},
                                    w[t], counts[t])
        chain = finalize(acc)["x"]
        torch.cuda.synchronize()
        check(torch.equal(out, chain),
              f"grad_aggregate {lbl} == accumulate_cohort->finalize (bitwise)")
        e = (out - plain).abs().max().item()
        check(e <= 1e-6, f"grad_aggregate {lbl} vs plain version, "
                         f"max_abs_err {e} <= 1e-6")
        err = max(err, e)
        t_n = g.shape[1]
        n_bytes = g.numel() * 4 + m.numel() * 4 + t_n * 4
        ms = time_ms(lambda: grad_aggregate(g, m, w, w_den=wd))
        pms = time_ms(lambda: grad_aggregate_ref(g, m, w, wd))
        dms = kernel_device_ms(lambda: grad_aggregate(g, m, w, w_den=wd),
                               "grad_aggregate_kernel")
        print(f"kernel grad_aggregate {lbl} T=4 N={t_n}: ms={ms:.6f} "
              f"plain_ms={pms:.6f} bound_ms={bound_ms(n_bytes):.6f} "
              f"device_ms={dms} bytes={n_bytes}")
        if lbl == "paper(10, 10)":
            rows["grad_aggregate"] = dict(ms=ms, plain_ms=pms,
                                          bound_ms=bound_ms(n_bytes))
    rows["grad_aggregate"]["max_abs_err"] = err

    err = 0.0
    for lbl, gs, ms_, shape in _scatter_cases(device):
        out = structured_scatter_batched(gs, ms_, w, wd, out_shape=shape)
        g3s, m3s, scalar, lrc = leaf_views(gs, ms_, shape)
        plain = scatter_views_ref(g3s, m3s, scalar, w, wd, lrc).reshape(
            out.shape)
        torch.cuda.synchronize()
        check(torch.equal(out, plain),
              f"structured_scatter {lbl} == plain version (bitwise)")
        e = (out - plain).abs().max().item()
        err = max(err, e)
        n_bytes = (sum(g.numel() * 4 + m.numel() * 4 for g, m in zip(gs, ms_))
                   + out.numel() * 4)
        kms = time_ms(lambda: structured_scatter_batched(gs, ms_, w, wd,
                                                         out_shape=shape))
        pms = time_ms(lambda: scatter_views_ref(g3s, m3s, scalar, w, wd, lrc))
        dms = kernel_device_ms(
            lambda: structured_scatter_batched(gs, ms_, w, wd, out_shape=shape),
            "structured_scatter_kernel")
        print(f"kernel structured_scatter {lbl} L={lrc[0]} "
              f"locals={[tuple(g.shape[1:]) for g in gs]}: ms={kms:.6f} "
              f"plain_ms={pms:.6f} bound_ms={bound_ms(n_bytes):.6f} "
              f"device_ms={dms} bytes={n_bytes}")
        if lbl == "paper(10, 10)x4":
            rows["structured_scatter"] = dict(ms=kms, plain_ms=pms,
                                              bound_ms=bound_ms(n_bytes))
    rows["structured_scatter"]["max_abs_err"] = err
    return rows


# --------------------------------------------------------------- slice

def _run(scenario, engine, device, label):
    import torch
    from repro_torch.fl import simulate
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulate(scenario, ROUNDS, engine=engine, device=device)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / ROUNDS * 1e3
    losses = res.losses
    print(f"slice {label} engine={engine}: ms_per_round={ms:.3f} "
          f"agg_backend={res.agg_backend} loss[1]={losses[0]:.6f} "
          f"loss[{ROUNDS}]={losses[-1]:.6f}")
    check(all(l is not None and l == l and abs(l) != float("inf")
              for l in losses), f"{label}/{engine}: losses finite")
    check(losses[-1] < losses[0], f"{label}/{engine}: loss falls over "
                                  f"{ROUNDS} rounds")
    return res


def _fused_run(scenario, device, label, expect_backend, per_round):
    """The main path: scan_pallas with every launch counter zeroed just
    before and read just after."""
    from repro_torch.kernels.grad_aggregate import grad_aggregate
    from repro_torch.kernels.structured_scatter import structured_scatter
    grad_aggregate.launches = 0
    structured_scatter.launches = 0
    res = _run(scenario, "scan_pallas", device, label)
    got = {"grad_aggregate": grad_aggregate.launches,
           "structured_scatter": structured_scatter.launches}
    print(f"slice {label}: launches={json.dumps(got)} per_round="
          f"{json.dumps({k: v / ROUNDS for k, v in got.items()})}")
    check(res.agg_backend == expect_backend,
          f"{label}: agg_backend == {expect_backend!r}")
    for k, n in per_round.items():
        check(got[k] == n * ROUNDS, f"{label}: {k} launched {n} per round")
    return res, got


def _same_params(a, b) -> float:
    import torch
    if all(torch.equal(a[k], b[k]) for k in a):
        return 0.0
    return max((a[k] - b[k]).abs().max().item() for k in a)


def profile_rounds(scenario, device, label: str, rounds: int = 5) -> None:
    """Where a round's time goes: host wall per round against the device
    time of every kernel and copy in a profiled scan_pallas window."""
    import collections
    import types

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import optim
    from repro_torch.configs.paper_mlp import config
    from repro_torch.fl import ScanEngine, build_server
    from repro_torch.models import mlp
    srv = build_server(scenario, types.SimpleNamespace(loss_fn=mlp.loss_fn),
                       optim.sgd(1.0),
                       mlp.init(torch.Generator().manual_seed(0), config()),
                       device=device)
    eng = ScanEngine(srv, agg="pallas")
    eng.run(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(rounds)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = device_events(prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    by_name = collections.Counter()
    for e in ev:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
    print(f"profile {label}: wall_ms_per_round={wall_ms / rounds:.3f} "
          f"device_busy_ms_per_round={busy_ms / rounds:.3f} "
          f"device_busy_share={busy_ms / wall_ms:.4f} "
          f"device_ops_per_round={len(ev) / rounds:.1f} (profiled)")
    for name, t in by_name.most_common(6):
        print(f"profile {label}: top device time {t / rounds:.4f} ms/round "
              f"{name}")


def phase_slice(device) -> dict:
    import torch
    from repro_torch.fl import (FleetSpec, FLScenario, LocalTraining,
                                ParticipationPolicy, UploadPolicy, simulate)
    fleet = FleetSpec.cycling(BENCH_TIERS, 256, samples_per_client=16)
    masked = FLScenario(fleet=fleet)
    width = FLScenario(fleet=fleet, local=LocalTraining(submodel="width"))
    fedavg = FLScenario(
        fleet=FleetSpec.cycling(QUICKSTART_TIERS, 256, samples_per_client=16),
        local=LocalTraining(mode="fedavg"),
        upload=UploadPolicy(quant="fp8_e4m3", error_feedback=True))

    # agreement with the port's CPU path on a small input
    small = FLScenario(fleet=FleetSpec.cycling(BENCH_TIERS, 16),
                       participation=ParticipationPolicy(0.5, seed=11))
    cpu = simulate(small, 3, device="cpu")
    gpu = simulate(small, 3, engine="scan_pallas", device=device)
    diff = max((cpu.params[k] - gpu.params[k].cpu()).abs().max().item()
               for k in cpu.params)
    check(diff <= 1e-5, f"small fleet: CUDA scan_pallas params vs CPU eager, "
                        f"max_abs_err {diff} <= 1e-5")

    # warm-up: first CUDA use of each path (library handles, kernel loads)
    for sc in (masked, width):
        simulate(sc, 2, engine="scan_pallas", device=device)
    launches = {"grad_aggregate": 0, "structured_scatter": 0}

    _run(masked, "eager", device, "masked")
    ref = _run(masked, "scan", device, "masked")
    res, got = _fused_run(masked, device, "masked", "pallas",
                          {"grad_aggregate": 6, "structured_scatter": 0})
    launches = {k: launches[k] + v for k, v in got.items()}
    check(_same_params(ref.params, res.params) == 0.0,
          "masked: scan_pallas params == scan params (bitwise)")

    _run(width, "eager", device, "width")
    ref = _run(width, "scan", device, "width")
    res, got = _fused_run(width, device, "width", "pallas_structured",
                          {"grad_aggregate": 0, "structured_scatter": 5})
    launches = {k: launches[k] + v for k, v in got.items()}
    check(_same_params(ref.params, res.params) == 0.0,
          "width: scan_pallas params == scan params (bitwise)")

    ref = _run(fedavg, "scan", device, "fedavg_fp8_ef")
    res, got = _fused_run(fedavg, device, "fedavg_fp8_ef", "pallas",
                          {"grad_aggregate": 6, "structured_scatter": 0})
    launches = {k: launches[k] + v for k, v in got.items()}
    d = _same_params(ref.params, res.params)
    print(f"slice fedavg_fp8_ef: scan_pallas vs scan max_abs_err={d}")
    check(d <= 1e-5, "fedavg_fp8_ef: scan_pallas params == scan to 1e-5")
    for label, sc in (("masked", masked), ("width", width),
                      ("fedavg_fp8_ef", fedavg)):
        profile_rounds(sc, device, label)
    return launches


# ---------------------------------------------------------------- main

def main() -> int:
    # before CUDA starts: deterministic cuBLAS, so the bitwise checks test
    # the aggregation and not GEMM reduction order
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    device = torch.device("cuda")
    try:
        rows = phase_kernels(device)
        launches = phase_slice(device)
    except CheckFailed as e:
        print(f"CHECK FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for name, replaces in (
            ("grad_aggregate",
             "src/repro/kernels/grad_aggregate/kernel.py:51"),
            ("structured_scatter",
             "src/repro/kernels/structured_scatter/kernel.py:142")):
        r = rows[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{name}.cu",
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": "bytes", "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
