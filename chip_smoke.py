"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the port's five CUDA sources from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, in parallel) and prints the compiler's
   resource report.
2. Phase "kernels": calls every kernel at the shapes its paths give it
   and holds it against its plain PyTorch version on the card:
   - the grouped aggregation kernel (fleet_aggregate) through the
     reference's one-leaf APIs at the FL round's shapes (the paper MLP,
     the 256-wide width-fleet MLP, a ragged size, scalar masks):
     structured_scatter bitwise its plain version, grad_aggregate
     bitwise the port's accumulate_cohort -> finalize chain and to atol
     1e-6 against its plain version, each call's launches counted; then
     llama3.2-3b's ``layers.mlp.wi.w`` (3072, 8192) at T = 4 with full
     0/1 masks and as its width twin, bitwise, with the achieved TB/s;
     the event time of a one-element ``x.add_(0)`` as the launch floor;
     and the grouped launch captured in a CUDA graph and replayed,
     bitwise the eager call, also after its inputs change in place;
   - fake_quant bitwise against the plain ``quantize_em`` for every
     format with e > 0, at every compressible leaf shape of llama3.2-3b
     (full config) and the paper MLP's leaf and upload shapes, with
     specials and f32 subnormals mixed in;
   - flash_attention at the train shape (B 2, T = S 1024, H 24, Hkv 8,
     hd 128) in f32 (atol/rtol 2e-5) and bf16 (one bf16 quantum of the
     plain version's f32 result, plus 2e-5), and in each dtype with a
     window, a q_offset with a ragged S and a ragged non-causal case;
     in bf16 also granite-3-2b's widths (hd 64), a q_offset < 0 whose
     blind rows must be exactly 0, and the smoke config's hd 32. Each
     case's launch must take its route: bf16 at hd 64 and 128 the
     tensor-core kernel (wgmma), f32 and hd 32 the CUDA-core one (simt);
   then times kernel and plain version with CUDA events (median), the
   kernel's device time from the profiler, the bound (the larger of
   bytes / 3.35 TB/s and operations / 989 TFLOP/s bf16, 67 TFLOP/s f32)
   and, for attention, PyTorch's scaled_dot_product_attention as a
   yardstick (the train bf16 and f32 rows are flash_attention's two
   routes in the kernels line; granite's row is printed only);
   - masked_matmul and codebook_matmul through the public kernel API at
     llama3.2-3b's MLP widths (one layer's wi (3072, 8192) and wo (8192,
     3072), x at M = 256 and 8192), plus a ragged shape and the paper
     MLP's: masked_matmul under the low tier's mask in f32 and bf16,
     forward and both gradients by autograd against the plain version's
     autograd (f32: rtol 1e-4, atol 1e-4 x sqrt(contraction length);
     bf16: one quantum plus 16 f32 unit roundoffs of the sum of the
     products' magnitudes), dw exactly 0 where the mask is 0; in bf16
     also a mask of 0 or uniform values in [0, 1) (dw bitwise the
     kernel's own x^T @ g rounded and masked in bf16), a ragged shape
     TMA describes and one it refuses; each case's launches per route
     (every bf16 case but the refused shape on the wgmma kernel);
     codebook_matmul on the embedded tier's k = 16 clustering (int8,
     int32, int64 narrowed by the wrapper) and k = 256 (int32), f32 x
     and (int8 k = 16, int32 k = 256) bf16 x, within the same bars (bf16:
     of sum |x||c|), each case's launch on its route (every case at
     llama3.2-3b's widths on the wgmma kernel; idx rows padded to N + 4
     bytes, the ragged and the paper-MLP shapes on the CUDA cores).
     Those calls are the matmuls' main path: counters zeroed just
     before, read just after. Then each forward is timed against its
     plain version and ``torch.matmul`` on the decoded or masked weight
     (in f32 for codebook_matmul, the product the function is), with
     the bound at the operands' peak: 67 TFLOP/s for f32 (CUDA cores),
     989 TFLOP/s for bf16 (tensor cores; codebook_matmul's wgmma route
     counts its three or six bf16 products); the f32 and the bf16 train
     rows are masked_matmul's two routes in the kernels line, the padded
     f32 and the int8 bf16 train rows codebook_matmul's.
3. Phase "slice": ``simulate`` on the card at the 256-client bench fleet,
   20 rounds each: the masked fleet (eager, scan, scan_pallas), its
   width-sliced twin (scan, scan_pallas) and FedAvg with fp8 uploads and
   error feedback on the six-tier quickstart fleet (scan, scan_pallas).
   Launch counters are zeroed just before each scan_pallas run and read
   just after: one fleet_aggregate launch a round, none through the
   one-leaf wrappers; scan_pallas must equal scan bitwise on the masked
   and width fleets; losses must be finite and fall; a small run must
   agree with the port's CPU path. Then one real round's aggregation
   step of each fleet: the grouped call bitwise the sequential chain and
   the per-leaf route, each timed.
   Phase "client": the per-client runtime on the paper's 8-device
   Dirichlet fleet (4000 samples, alpha 0.5), 60 rounds each of all-hub
   FedSGD, hetero FedSGD, FedAvg and fp8 uploads with EF: losses fall,
   val_acc >= 0.97 on 1000 held-out samples; then 2 rounds of the
   256-client bench fleet per client against the cohort runtime, params
   within 1e-5.
   Phase "async": the 256-client bench fleet and its width twin under
   AsyncBuffered(64, 0.5, jitter 0.2), 20 windows eager and scan
   (bitwise equal), then the full-buffer, no-discount limit against the
   sync-wait cohort run (1e-6).
4. Phase "serve": llama3.2-3b at its full config (28 layers, bf16
   compute), compressed for each tier hub / high / mid / low / embedded
   through ``repro_torch.launch.serve``: batch 4, prompt 64, 32 greedy
   tokens; fake_quant must launch 10 times per quantized tier and never
   for the hub. At 2 layers of full width in f32, the decode replay of the
   prompt must agree with prefill's last-token logits.
5. Phase "train": llama3.2-3b at full width cut to 4 layers, bf16,
   ``use_flash``, through ``repro_torch.launch.train``: 4 tiers,
   AdamW(warmup_cosine(3e-4, 2, 5)), global batch 8, seq 1024, 5 steps;
   flash_attention must launch 16 times per step, all on the wgmma
   kernel, and fake_quant 30 times per step; the
   mean loss and each tier's must fall at each of the last two steps
   (after the jump that AdamW's first updates make at this width, as in
   the reference), and the same run without flash must give the same
   losses to rtol 1e-3. On the llama smoke
   config the card's f32 step must agree with the port's CPU path over 2
   steps, its flash_attention launches all on the simt kernel.

Prints the card's name and power limit, per-kernel times, launches per
round and per step, ms per round and per window, val_acc, prefill s,
decode tokens/s, sec/step and peak memory, a profiled window of each FL
fleet, of the client and async runtimes, one serve call and one train
step, then the kernels JSON line (every TPU kernel's row: grad_aggregate and
structured_scatter both from the grouped kernel; flash_attention,
masked_matmul and codebook_matmul once per route, each row with its
device ms and its max_abs_err over its route's cases in the dtype of its
ms) and, last, the ``{"ok": true, ...}`` line. Any failed check exits non-zero. Needs a
CUDA GPU and the repository's ``src/`` beside this file; exits non-zero
without either.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
BF16_FLOP_PER_S = 989e12            # H100 SXM dense bf16 tensor-core rate
F32_FLOP_PER_S = 67e12              # H100 SXM f32 rate outside the tensor cores
ROUNDS = 20
LM_ARCH = "llama3.2-3b"
TRAIN_LAYERS = 4                    # the train phase's depth cut (of 28)
TRAIN_STEPS = 5
BENCH_TIERS = ("hub", "high", "mid", "low")
QUICKSTART_TIERS = ("hub", "high", "mid", "mid", "low", "embedded")
LARGE_LEAF = (3072, 8192)           # llama3.2-3b's layers.mlp.wi.w


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


def bound_ms(n_bytes: int, flops: float = 0.0,
             flop_rate: float = BF16_FLOP_PER_S) -> float:
    """The least time for the work: the larger of moving ``n_bytes`` at
    the memory rate and doing ``flops`` at ``flop_rate``."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / flop_rate) * 1e3


def device_events(prof) -> list:
    """The device-side events (kernels, copies) of a profiler trace."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def kernel_device_ms(fn, kernel: str, calls: int = 200):
    """Device time of the kernels whose names hold ``kernel`` per call of
    ``fn`` (all of a call's launches: masked_matmul's split-K pass runs
    two), mean over ``calls`` calls, from the profiler's device trace
    (None if the trace has no such kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in device_events(prof) if kernel in e.name]
    return (sum(e.time_range.elapsed_us() for e in ev) / calls / 1e3
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
    widths 1, 1, 0.5, 0.25)."""
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


def _scatter_plain(gs, ms, wn, wd, shape):
    """The plain version of a batched structured_scatter call: each of
    the L leaves through the one-leaf chain."""
    import torch
    from repro_torch.kernels.fleet_aggregate.ref import aggregate_leaf_ref
    from repro_torch.kernels.structured_scatter.ref import leaf_views
    g3s, m3s, (L, R, C) = leaf_views(gs, ms, shape)
    return torch.stack([aggregate_leaf_ref(
        (R, C), [(g[l], m[l]) for g, m in zip(g3s, m3s)], wn, wd)
        for l in range(L)]).reshape((L,) + tuple(shape))


def _large_leaf_cases(device):
    """(label, leaves) for llama3.2-3b's ``layers.mlp.wi.w`` (3072, 8192)
    at T = 4 (the bench tiers): full 0/1 masks on every tier (masked),
    and its width twin, each tier's prefix block from ``submodel_spec``
    with the leaf between two others, as in the model."""
    import torch
    from repro_torch.core.compression import DEVICE_TIERS, submodel_spec
    shape = LARGE_LEAF
    meta = {"wq": torch.empty((8, shape[0]), device="meta"),
            "wi": torch.empty(shape, device="meta"),
            "wo": torch.empty((shape[1], 8), device="meta")}
    locs = {"masked": [shape] * 4,
            "width": [submodel_spec(
                meta, DEVICE_TIERS[t].as_width_sliced().width).local_shape(1)
                for t in BENCH_TIERS]}
    gen = torch.Generator(device=device).manual_seed(3)
    cases = []
    for tag, loc in locs.items():
        tiers = [(torch.randn(s, generator=gen, device=device),
                  (torch.rand(s, generator=gen, device=device) < 0.6).float())
                 for s in loc]
        cases.append((f"llama_wi_{tag}", {"layers.mlp.wi.w": (shape, tiers)}))
    return cases


def _leaves_bytes(leaves: dict) -> int:
    """Bytes a grouped call must move: each tier's update and mask read
    once (a scalar mask is 4 bytes), each output written once."""
    import math
    return sum(sum(g.numel() * 4 + m.numel() * 4 for g, m in tiers)
               + math.prod(shape) * 4 for shape, tiers in leaves.values())


def _graph_replay_check(device) -> None:
    """The grouped launch captured in a CUDA graph, replayed, bitwise the
    eager call, also after its inputs change in place."""
    import torch
    from repro_torch.kernels.fleet_aggregate import fleet_aggregate
    from repro_torch.core.compression import DEVICE_TIERS, submodel_spec
    from repro_torch.configs.paper_mlp import config
    params = _mlp_params(config(), "cpu")
    gen = torch.Generator().manual_seed(4)
    specs = [submodel_spec(params, DEVICE_TIERS[t].as_width_sliced().width)
             for t in BENCH_TIERS]
    leaves = {}
    for i, (k, p) in enumerate(params.items()):
        tiers = []
        for s in specs:
            loc = s.local_shape(i)
            m = ((torch.rand(loc, generator=gen) < 0.7).float() if p.dim() > 1
                 else torch.ones(()))
            tiers.append((torch.randn(loc, generator=gen).to(device),
                          m.to(device)))
        leaves[k] = (tuple(p.shape), tiers)
    wn, wd = [1.0, 1.0, 1.0, 1.0], [64.0, 64.0, 0.0, 64.0]
    eager = {k: v.clone() for k, v in fleet_aggregate(leaves, wn, wd).items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fleet_aggregate(leaves, wn, wd)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fleet_aggregate(leaves, wn, wd)
    graph.replay()
    torch.cuda.synchronize()
    check(all(torch.equal(out[k], eager[k]) for k in leaves),
          "fleet_aggregate captured in a CUDA graph: replay == eager "
          "(bitwise)")
    for _, tiers in leaves.values():
        for g, _ in tiers:
            g.mul_(-3.0)
    graph.replay()
    want = fleet_aggregate(leaves, wn, wd)
    torch.cuda.synchronize()
    check(all(torch.equal(out[k], want[k]) for k in leaves),
          "fleet_aggregate graph replay after in-place input changes == "
          "eager (bitwise)")


def phase_kernels(device) -> dict:
    import torch
    from repro_torch.core.aggregation import accumulate_cohort, f32, finalize
    from repro_torch.kernels.fleet_aggregate import fleet_aggregate
    from repro_torch.kernels.fleet_aggregate.ref import aggregate_leaf_ref
    from repro_torch.kernels.grad_aggregate import grad_aggregate
    from repro_torch.kernels.grad_aggregate.ref import grad_aggregate_ref
    from repro_torch.kernels.structured_scatter import (
        structured_scatter_batched)
    from repro_torch.kernels.structured_scatter.ops import structured_scatter
    w = [1.0, 1.0, 1.0, 1.0]
    counts = [64.0, 64.0, 0.0, 64.0]
    wd = [f32(f32(a) * f32(c)) for a, c in zip(w, counts)]
    rows = {}
    one = torch.zeros(1, device=device)
    floor_ms = time_ms(lambda: one.add_(0))
    print(f"kernel launch floor: x.add_(0) on one element ms={floor_ms:.6f}")

    err = 0.0
    for lbl, g, m in _grad_cases(device):
        before = fleet_aggregate.launches
        out = grad_aggregate(g, m, w, w_den=wd)
        check(fleet_aggregate.launches == before + 1,
              f"grad_aggregate {lbl}: one fleet_aggregate launch")
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
                               "fleet_aggregate_kernel")
        print(f"kernel grad_aggregate {lbl} T=4 N={t_n}: ms={ms:.6f} "
              f"plain_ms={pms:.6f} bound_ms={bound_ms(n_bytes):.7f} "
              f"device_ms={dms} bytes={n_bytes} launches_per_call=1 "
              f"launch_floor_ms={floor_ms:.6f}")
        if lbl == "paper(10, 10)":
            rows["grad_aggregate"] = dict(ms=ms, plain_ms=pms, device_ms=dms,
                                          bound_ms=bound_ms(n_bytes))
    rows["grad_aggregate"]["max_abs_err"] = err

    err = 0.0
    for lbl, gs, ms_, shape in _scatter_cases(device):
        before = fleet_aggregate.launches
        out = structured_scatter_batched(gs, ms_, w, wd, out_shape=shape)
        n_launch = fleet_aggregate.launches - before
        plain = _scatter_plain(gs, ms_, w, wd, shape)
        torch.cuda.synchronize()
        check(torch.equal(out, plain),
              f"structured_scatter {lbl} == plain version (bitwise)")
        e = (out - plain).abs().max().item()
        err = max(err, e)
        n_bytes = (sum(g.numel() * 4 + m.numel() * 4 for g, m in zip(gs, ms_))
                   + out.numel() * 4)
        kms = time_ms(lambda: structured_scatter_batched(gs, ms_, w, wd,
                                                         out_shape=shape))
        pms = time_ms(lambda: _scatter_plain(gs, ms_, w, wd, shape))
        dms = kernel_device_ms(
            lambda: structured_scatter_batched(gs, ms_, w, wd, out_shape=shape),
            "fleet_aggregate_kernel")
        print(f"kernel structured_scatter {lbl} L={gs[0].shape[0]} "
              f"locals={[tuple(g.shape[1:]) for g in gs]}: ms={kms:.6f} "
              f"plain_ms={pms:.6f} bound_ms={bound_ms(n_bytes):.7f} "
              f"device_ms={dms} bytes={n_bytes} launches_per_call={n_launch}")
        if lbl == "paper(10, 10)x4":
            rows["structured_scatter"] = dict(ms=kms, plain_ms=pms,
                                              device_ms=dms,
                                              bound_ms=bound_ms(n_bytes))
    rows["structured_scatter"]["max_abs_err"] = err
    check(structured_scatter.launches > 0, "structured_scatter counts its "
                                           "launches")

    wn = [1.0, 1.0, 1.0, 1.0]
    for lbl, leaves in _large_leaf_cases(device):
        out = fleet_aggregate(leaves, wn, wd)
        for k, (shape, tiers) in leaves.items():
            plain = aggregate_leaf_ref(shape, tiers, wn, wd)
            torch.cuda.synchronize()
            check(torch.equal(out[k], plain),
                  f"fleet_aggregate {lbl} == plain version (bitwise)")
        del out, plain
        n_bytes = _leaves_bytes(leaves)
        ms = time_ms(lambda: fleet_aggregate(leaves, wn, wd), reps=10, inner=10)
        dms = kernel_device_ms(lambda: fleet_aggregate(leaves, wn, wd),
                               "fleet_aggregate_kernel", calls=50)
        locs = [tuple(g.shape) for g, _ in next(iter(leaves.values()))[1]]
        print(f"kernel fleet_aggregate {lbl} T=4 locals={locs}: ms={ms:.6f} "
              f"device_ms={dms:.6f} bound_ms={bound_ms(n_bytes):.6f} "
              f"bytes={n_bytes} TB/s={n_bytes / ms / 1e9:.3f} "
              f"device_TB/s={n_bytes / dms / 1e9:.3f}")
        del leaves
        torch.cuda.empty_cache()
    _graph_replay_check(device)
    return rows


# ---------------------------------------------------------- LM kernels

def _fq_input(shape, device, seed: int):
    """Normals over ~170 binades with specials and f32 subnormals mixed
    in, made on the card from a seed."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device)
    x *= torch.exp(torch.empty(shape, device=device).uniform_(
        -60.0, 60.0, generator=gen))
    flat = x.view(-1)
    n = flat.numel()
    specials = torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                             float("nan"), 1e-45, -1e-45, 3e38, -3e38, 481.0,
                             65520.0], device=device)
    k = min(n, specials.numel())
    flat[:k] = specials[:k]
    m = min(n - k, 1000)
    if m > 0:
        idx = torch.randint(k, n, (m,), generator=gen, device=device)
        flat[idx] = torch.randn((m,), generator=gen, device=device) * 1e-40
    return x


def _bitwise(a, b) -> bool:
    import torch
    return bool(torch.all((a.view(torch.int32) == b.view(torch.int32))
                          | (torch.isnan(a) & torch.isnan(b))))


def _max_abs_err(a, b) -> float:
    """Largest |a - b| over the elements where a and b are not both NaN
    (equal infinities count 0, a NaN against a number counts inf)."""
    import torch
    d = torch.where(a == b, 0.0, (a - b).abs())
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0,
                    d.nan_to_num(nan=float("inf")))
    return d.max().item()


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _route_errors(kernel: str, err: dict, rows: dict, names: dict) -> None:
    """Print ``err`` ((route, dtype) -> the largest error over that
    route's cases in that dtype) and give each kernels-line row the error
    of its own route and dtype, the dtype its ms was timed in."""
    print(f"{kernel} max_abs_err by route and dtype: " + json.dumps(
        {f"{r}/{d}": e for (r, d), e in sorted(err.items())}))
    for route, name in names.items():
        rows[name]["max_abs_err"] = err[(route, rows[name]["dtype"])]


def _fq_shapes() -> dict:
    """shape -> label: every compressible leaf shape of llama3.2-3b at its
    full config (the serve phase checks the table against the real
    params), and the paper MLP's leaf shapes and upload shapes (a
    256-client axis in front of every leaf)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.paper_mlp import config
    from repro_torch.core.compression import compressible
    shapes = {}
    for name, shape in _lm_leaf_shapes(get_config(LM_ARCH)).items():
        if compressible(name, torch.empty(shape, device="meta")):
            shapes.setdefault(shape, f"llama {name}")
    for name, p in _mlp_params(config(), "cpu").items():
        shapes.setdefault(tuple(p.shape), f"paper-mlp {name}")
        shapes.setdefault((256,) + tuple(p.shape), f"paper-mlp upload {name}")
    return shapes


def _lm_leaf_shapes(cfg) -> dict:
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.head_dim
    return {"embed": (cfg.vocab_size, d), "final_norm": (d,),
            "layers.attn.wk.w": (L, d, cfg.num_kv_heads, hd),
            "layers.attn.wo.w": (L, cfg.num_heads * hd, d),
            "layers.attn.wq.w": (L, d, cfg.num_heads, hd),
            "layers.attn.wv.w": (L, d, cfg.num_kv_heads, hd),
            "layers.ln1": (L, d), "layers.ln2": (L, d),
            "layers.mlp.wg.w": (L, d, cfg.d_ff),
            "layers.mlp.wi.w": (L, d, cfg.d_ff),
            "layers.mlp.wo.w": (L, cfg.d_ff, d)}


def _flash_cases(device):
    """(label, q, k, v, kwargs, route) at llama3.2-3b's attention widths:
    the train phase's shape in bf16 (the wgmma kernel) and f32 (the simt
    kernel), then a window, a q_offset with a ragged S and a ragged
    non-causal case in each dtype; granite-3-2b's widths (hd 64) and a
    q_offset < 0 whose first rows see no key, in bf16; and the smoke
    config's hd 32 in bf16, which the simt kernel serves."""
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    cfg = get_config(LM_ARCH)
    granite = get_config("granite-3-2b")
    smoke = get_smoke_config(LM_ARCH)
    gen = torch.Generator(device=device).manual_seed(5)

    def qkv(b, t, s, dtype, c=cfg):
        return [torch.randn(shape, generator=gen, device=device).to(dtype)
                for shape in ((b, t, c.num_heads, c.head_dim),
                              (b, s, c.num_kv_heads, c.head_dim),
                              (b, s, c.num_kv_heads, c.head_dim))]

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("train_bf16", *qkv(2, 1024, 1024, bf16), {}, "wgmma"),
             ("train_f32", *qkv(2, 1024, 1024, f32), {}, "simt")]
    for tag, dtype, rt in (("f32", f32, "simt"), ("bf16", bf16, "wgmma")):
        cases += [(f"window_{tag}", *qkv(1, 300, 300, dtype),
                   dict(window=100), rt),
                  (f"q_offset_ragged_s_{tag}", *qkv(1, 64, 1000, dtype),
                   dict(q_offset=936), rt),
                  (f"noncausal_ragged_{tag}", *qkv(2, 77, 333, dtype),
                   dict(causal=False), rt)]
    return cases + [
        ("granite_bf16", *qkv(2, 1024, 1024, bf16, granite), {}, "wgmma"),
        ("masked_rows_bf16", *qkv(1, 300, 300, bf16), dict(q_offset=-100),
         "wgmma"),
        ("smoke_hd32_bf16", *qkv(2, 64, 64, bf16, smoke), {}, "simt")]


def flash_work(q, k, causal=True, window=0, q_offset=0):
    """(bytes, flops) of one attention call: q, k, v read and o written
    once; 4*hd flops per (query, key) pair that this call's masks let
    through, counted from the masks."""
    import numpy as np
    b, t, h, hd = q.shape
    s = k.shape[1]
    qp = q_offset + np.arange(t)[:, None]
    kp = np.arange(s)[None, :]
    mask = np.ones((t, s), bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return n_bytes, 4.0 * b * h * hd * int(mask.sum())


def phase_lm_kernels(device) -> dict:
    import torch
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention_forward
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.numerics import FORMATS, quantize_em
    rows = {}
    fmts = {n: f for n, f in FORMATS.items() if f.e_bits > 0}
    shapes = sorted(_fq_shapes().items(), key=lambda kv: math.prod(kv[0]))
    fq_err = 0.0
    for i, (shape, label) in enumerate(shapes):
        x = _fq_input(shape, device, seed=10 + i)
        bad, err = [], 0.0
        for n, f in fmts.items():
            out = fake_quant(x, f.e_bits, f.m_bits)
            ref = quantize_em(x, f.e_bits, f.m_bits)
            if not _bitwise(out, ref):
                bad.append(n)
            err = max(err, _max_abs_err(out, ref))
            del out, ref
        fq_err = max(fq_err, err)
        check(not bad, f"fake_quant {label} {shape} == quantize_em (bitwise) "
                       f"for {sorted(fmts)}; mismatched: {bad}, "
                       f"max_abs_err {err}")
        big = x.numel() > 10_000_000
        reps, inner = (5, 3) if big else (15, 20)
        n_bytes = 8 * x.numel()
        ms = time_ms(lambda: fake_quant(x, 4, 3), reps, inner)
        pms = time_ms(lambda: quantize_em(x, 4, 3), reps, inner)
        dms = kernel_device_ms(lambda: fake_quant(x, 4, 3),
                               "fake_quant_kernel", calls=10 if big else 200)
        print(f"kernel fake_quant {label} {shape} fp8_e4m3: ms={ms:.6f} "
              f"plain_ms={pms:.6f} bound_ms={bound_ms(n_bytes):.6f} "
              f"device_ms={dms} bytes={n_bytes}")
        if label == "llama embed":
            rows["fake_quant"] = dict(ms=ms, plain_ms=pms, device_ms=dms,
                                      bound_ms=bound_ms(n_bytes),
                                      bound_by="bytes", library_ms=None)
        del x
    rows["fake_quant"]["max_abs_err"] = fq_err

    # flash_attention: each case's launch must take its route
    err = {}                            # (route, dtype) -> max_abs_err
    routes = flash_attention.route_launches
    for label, q, k, v, kw, want in _flash_cases(device):
        before = dict(routes)
        out = flash_attention_forward(q, k, v, **kw).float()
        took = {r: routes[r] - before[r] for r in routes}
        ref = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        check(took == {r: int(r == want) for r in routes},
              f"flash_attention {label}: one launch on the {want} kernel, "
              f"took {took}")
        e = (out - ref).abs().max().item()
        if q.dtype == torch.float32:
            ok, tol = torch.allclose(out, ref, rtol=2e-5, atol=2e-5), \
                "rtol/atol 2e-5"
        else:
            _, ex = torch.frexp(ref)
            quantum = torch.ldexp(torch.ones_like(ref), ex - 8)
            ok = bool(torch.all((out - ref).abs() <= quantum + 2e-5))
            tol = "one bf16 quantum of the f32 result + 2e-5"
        check(ok, f"flash_attention {label} {tuple(q.shape)} vs plain "
                  f"version within {tol}, max_abs_err {e}")
        if kw.get("q_offset", 0) < 0:
            blind = out[:, :-kw["q_offset"]]
            check(not bool(blind.any()),
                  f"flash_attention {label}: the {blind.shape[1]} rows that "
                  f"see no key are exactly 0")
        key = (want, _dtype_name(q.dtype))
        err[key] = max(err.get(key, 0.0), e)
        if label not in ("train_bf16", "train_f32", "granite_bf16"):
            continue
        n_bytes, flops = flash_work(q, k, **kw)
        rate = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S
        bms = bound_ms(n_bytes, flops, rate)
        by = "bytes" if n_bytes / HBM_BYTES_PER_S >= flops / rate \
            else "operations"
        ms = time_ms(lambda: flash_attention_forward(q, k, v))
        pms = time_ms(lambda: flash_attention_ref(q, k, v), 7, 5)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
        # the yardstick is SDPA at its fastest: main() turns deterministic
        # algorithms on for the bitwise checks, which may steer SDPA to a
        # slower backend, so it is timed with them off, and on for the record
        lms_det = time_ms(sdpa)
        torch.use_deterministic_algorithms(False)
        try:
            lms = time_ms(sdpa)
        finally:
            torch.use_deterministic_algorithms(True)
        dms = kernel_device_ms(lambda: flash_attention_forward(q, k, v),
                               "flash_attention_kernel", calls=20)
        print(f"kernel flash_attention {label} route={want} "
              f"{tuple(q.shape)} kv {tuple(k.shape)}: ms={ms:.6f} "
              f"plain_ms={pms:.6f} sdpa_ms={lms:.6f} "
              f"sdpa_deterministic_ms={lms_det:.6f} bound_ms={bms:.6f} "
              f"({by}) device_ms={dms} tflops_useful="
              f"{flops / ms / 1e9:.3f} bytes={n_bytes} flops={flops:.0f}")
        name = {"train_bf16": "flash_attention_wgmma",
                "train_f32": "flash_attention"}.get(label)
        if name:
            rows[name] = dict(ms=ms, plain_ms=pms, device_ms=dms,
                              bound_ms=bms, bound_by=by, library_ms=lms,
                              dtype=_dtype_name(q.dtype))
    _route_errors("flash_attention", err, rows, {
        "wgmma": "flash_attention_wgmma", "simt": "flash_attention"})
    return rows


# ------------------------------------------------------ matmul kernels

def _mm_weights(device) -> dict:
    """One layer's ``layers.mlp.wi.w`` (3072, 8192) and
    ``layers.mlp.wo.w`` (8192, 3072) of llama3.2-3b, from the seeded init
    of a one-layer cut of the full config."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    p = get_model(get_config(LM_ARCH).replace(num_layers=1)).init(
        0, device=device)
    out = {"wi": p["layers.mlp.wi.w"][0].clone(),
           "wo": p["layers.mlp.wo.w"][0].clone()}
    del p
    return out


def _masked_cases(ws, device):
    """(label, x, w, mask, g) for masked_matmul: wi and wo under the low
    tier's mask (density 0.25, the port's magnitude_mask), x at M = 256
    (serve: batch 4 x prompt 64) and M = 8192 (train: 8 x 1024), f32 and
    bf16; then a ragged shape and the paper MLP's (16, 10) @ (10, 10) in
    f32; in bf16 a mask that is 0 or uniform in [0, 1) at (256, 3072) @
    (3072, 512), a ragged shape TMA describes, (136, 264) @ (264, 200),
    and one it refuses, (130, 257) @ (257, 129)."""
    import torch
    from repro_torch.core.compression import DEVICE_TIERS, magnitude_mask
    density = DEVICE_TIERS["low"].density
    gen = torch.Generator(device=device).manual_seed(21)
    cases = []
    for wname, w in ws.items():
        mask = magnitude_mask(w, density)
        for tag, m in (("serve", 256), ("train", 8192)):
            for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                x, g = (torch.randn(shape, generator=gen, device=device)
                        .to(dtype) for shape in ((m, w.shape[0]),
                                                 (m, w.shape[1])))
                cases.append((f"{tag}_{wname}_{dt}", x, w.to(dtype),
                              mask.to(dtype), g))
    for tag, (m, k, n) in (("ragged", (130, 257, 129)),
                           ("paper_mlp", (16, 10, 10))):
        x, w, g = (torch.randn(shape, generator=gen, device=device)
                   for shape in ((m, k), (k, n), (m, n)))
        cases.append((f"{tag}_f32", x, w, magnitude_mask(w, density), g))
    for tag, (m, k, n) in (("nonbinary", (256, 3072, 512)),
                           ("ragged_tma", (136, 264, 200)),
                           ("ragged", (130, 257, 129))):
        x, w, g = (torch.randn(shape, generator=gen, device=device)
                   for shape in ((m, k), (k, n), (m, n)))
        if tag == "nonbinary":
            mask = torch.where(torch.rand((k, n), generator=gen,
                                          device=device) < 0.5, 0.0,
                               torch.rand((k, n), generator=gen,
                                          device=device))
        else:
            mask = magnitude_mask(w, density)
        cases.append((f"{tag}_bf16", *(t.to(torch.bfloat16)
                                       for t in (x, w, mask, g))))
    return cases


def _expected_route(label: str) -> str:
    """The masked_matmul kernel each case's three launches must take:
    bf16 at llama3.2-3b's shapes and the TMA-describable ragged and
    non-binary shapes on the tensor cores, the rest on the CUDA cores."""
    return ("simt" if label.endswith("_f32") or label == "ragged_bf16"
            else "wgmma")


def _codebook_cases(ws, device):
    """(label, x, idx, codebook) for codebook_matmul: wi (and wo) pruned
    like the embedded tier and clustered by the port's kmeans_codebook /
    assign_codebook at its k = 16 (int8 and int32 indices) and at k = 256
    (int32), x at M = 256 and 8192 in f32 (and in bf16 for int8 k = 16
    and int32 k = 256); then the train int8 case with idx rows padded to
    N + 4 bytes (which TMA refuses), a ragged shape and the paper MLP's."""
    import torch
    from repro_torch.core.compression import DEVICE_TIERS, magnitude_mask
    from repro_torch.core.compression.clustering import (assign_codebook,
                                                         kmeans_codebook)
    emb = DEVICE_TIERS["embedded"]
    gen = torch.Generator(device=device).manual_seed(22)

    def clustered(w, k):
        w = w * magnitude_mask(w, emb.density)
        cb = kmeans_codebook(w, k)
        return assign_codebook(w, cb), cb

    cases, xs = [], {}
    i16, cb16 = clustered(ws["wi"], emb.cluster_k)
    i256, cb256 = clustered(ws["wi"], 256)
    i8, i32, i256 = i16.to(torch.int8), i16.to(torch.int32), i256.int()
    for tag, m in (("serve", 256), ("train", 8192)):
        x = xs[tag] = torch.randn((m, ws["wi"].shape[0]), generator=gen,
                                  device=device)
        xb = x.to(torch.bfloat16)
        cases += [(f"{tag}_wi_k16_int8", x, i8, cb16),
                  (f"{tag}_wi_k16_int32", x, i32, cb16),
                  (f"{tag}_wi_k256_int32", x, i256, cb256),
                  (f"{tag}_wi_k16_int8_bf16", xb, i8, cb16),
                  (f"{tag}_wi_k256_int32_bf16", xb, i256, cb256)]
    k, n = i8.shape
    padded = torch.zeros((k, n + 4), dtype=torch.int8, device=device)
    cases.append(("train_wi_k16_int8_padded", xs["train"],
                  padded[:, :n].copy_(i8), cb16))
    iwo, cbwo = clustered(ws["wo"], emb.cluster_k)
    cases.append(("serve_wo_k16_int64", torch.randn(
        (256, ws["wo"].shape[0]), generator=gen, device=device), iwo, cbwo))
    for tag, (m, k, n) in (("ragged", (130, 257, 129)),
                           ("paper_mlp", (16, 10, 10))):
        idx, cb = clustered(torch.randn((k, n), generator=gen,
                                        device=device), emb.cluster_k)
        cases.append((f"{tag}_k16_int8", torch.randn(
            (m, k), generator=gen, device=device), idx.to(torch.int8), cb))
    return cases


def _codebook_route(label: str) -> str:
    """The codebook_matmul kernel each case must take: every case at
    llama3.2-3b's widths on the tensor cores, f32 x or bf16, int8 read in
    place or int32 / int64 narrowed; the padded idx rows, the ragged
    shape's (257 f32 and 129 int8 elements) and the paper MLP's (10)
    rows, which TMA refuses, on the CUDA cores."""
    return ("simt" if label.startswith(("ragged", "paper_mlp"))
            or label.endswith("_padded") else "wgmma")


F32_UNIT_ROUNDOFF = 2.0 ** -24
SUM_ROUNDOFFS = 16      # f32 roundoffs of sum |a||b| allowed between orders


def _bf16_quantum(t):
    """The bf16 spacing at each element of ``t`` (0 at 0)."""
    import torch
    q = torch.ldexp(torch.ones_like(t), torch.frexp(t)[1] - 8)
    return torch.where(t == 0, torch.zeros_like(t), q)


def _mm_within(out, ref, depth: int, abs_sum=None):
    """f32: rtol 1e-4 and atol 1e-4 x sqrt(contraction length), the
    reference test's bound (another summation order). bf16: both round an
    f32 sum of the same bf16 products (exact in f32), taken in other
    orders. Two such sums differ by a few f32 roundoffs of ``abs_sum`` =
    sum |a||b| (the products' magnitudes); rounding each to bf16 adds at
    most half a quantum of each. So |out - ref| <= the larger quantum of
    the two + SUM_ROUNDOFFS * 2^-24 * abs_sum."""
    import torch
    if out.dtype == torch.float32:
        return bool(torch.allclose(out, ref, rtol=1e-4,
                                   atol=1e-4 * depth ** 0.5))
    return bool(torch.all(_bf16_excess(out, ref, abs_sum) <= SUM_ROUNDOFFS))


def _bf16_excess(out, ref, abs_sum):
    """max(|out - ref| - the larger bf16 quantum, 0) in f32 roundoffs of
    ``abs_sum``, per element: what the bf16 check compares with
    SUM_ROUNDOFFS."""
    import torch
    out, ref = out.float(), ref.float()
    q = torch.maximum(_bf16_quantum(out), _bf16_quantum(ref))
    over = ((out - ref).abs() - q).clamp_min(0)
    return torch.where(over == 0, torch.zeros_like(over),
                       over / (F32_UNIT_ROUNDOFF * abs_sum))


def _masked_abs_sums(x, w, mask, g):
    """sum |a||b| of the products behind y, dx and dw, in f32: |x| @
    |w*mask|, |g| @ |w*mask|^T and (|x|^T @ |g|) * mask."""
    import torch
    ax, ag = x.float().abs(), g.float().abs()
    awm = (w.float() * mask.float()).abs()
    return ax @ awm, ag @ awm.t(), (ax.t() @ ag) * mask.float()


def _mm_work(x, n: int, b_bytes: int):
    """(bytes, flops) of one product x (M, K) @ B (K, N): x, B's inputs
    and the output moved once; 2*M*K*N operations."""
    m, k = x.shape
    return (x.numel() * x.element_size() + b_bytes
            + m * n * x.element_size()), 2.0 * m * k * n


def phase_matmul_kernels(device) -> tuple[dict, dict]:
    """The public kernel API's two matmuls. The main path (counters
    zeroed just before, read just after) runs masked_matmul forward and
    backward through autograd and codebook_matmul forward on every case;
    its results are then held against the plain versions, and each
    forward is timed. Returns (rows, launches)."""
    import torch
    from repro_torch.kernels import codebook_matmul, masked_matmul
    from repro_torch.kernels.codebook_matmul.ref import (codebook_matmul_ref,
                                                         decode)
    from repro_torch.kernels.masked_matmul.ops import masked_product
    from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref
    ws = _mm_weights(device)
    mcases = _masked_cases(ws, device)
    ccases = _codebook_cases(ws, device)
    del ws

    def fwd_bwd(fn, x, w, mask, g):
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(xl, wl, mask)
        return (y.detach(), *torch.autograd.grad(y, (xl, wl), g))

    torch.cuda.synchronize()
    masked_matmul.launches = 0
    routes = masked_matmul.route_launches
    for r in routes:
        routes[r] = 0
    codebook_matmul.launches = 0
    croutes = codebook_matmul.route_launches
    for r in croutes:
        croutes[r] = 0
    m_out, m_routes, c_out, c_routes = {}, {}, {}, {}
    for lbl, x, w, m, g in mcases:
        before = dict(routes)
        m_out[lbl] = fwd_bwd(masked_matmul, x, w, m, g)
        m_routes[lbl] = {r: routes[r] - before[r] for r in routes}
    for lbl, x, idx, cb in ccases:
        before = dict(croutes)
        c_out[lbl] = codebook_matmul(x, idx, cb)
        c_routes[lbl] = {r: croutes[r] - before[r] for r in croutes}
    torch.cuda.synchronize()
    launches = {"masked_matmul": masked_matmul.launches,
                "masked_matmul_wgmma": routes["wgmma"],
                "masked_matmul_simt": routes["simt"],
                "codebook_matmul_calls": codebook_matmul.launches,
                "codebook_matmul_wgmma": croutes["wgmma"],
                "codebook_matmul_simt": croutes["simt"]}
    print(f"matmul main path: launches={json.dumps(launches)} over "
          f"{len(mcases)} masked (forward + dx + dw) and {len(ccases)} "
          f"codebook calls")
    for lbl, _, _, _, _ in mcases:
        print(f"masked_matmul {lbl}: launches per route "
              f"{json.dumps(m_routes[lbl])}")
    check(launches["masked_matmul"] == 3 * len(mcases),
          "masked_matmul launched 3 times per forward + backward")
    check(all(m_routes[lbl][_expected_route(lbl)] == 3
              for lbl, _, _, _, _ in mcases),
          "masked_matmul: every bf16 case at llama3.2-3b's shapes, the "
          "non-binary and the TMA ragged case on the wgmma kernel, f32 and "
          "the (130, 257, 129) bf16 case on the CUDA-core kernel")
    check(launches["codebook_matmul_calls"] == len(ccases),
          "codebook_matmul launched once per call")
    for lbl, _, _, _ in ccases:
        print(f"codebook_matmul {lbl}: launches per route "
              f"{json.dumps(c_routes[lbl])}")
    check(all(c_routes[lbl] == {r: int(r == _codebook_route(lbl))
                                for r in croutes} for lbl, _, _, _ in ccases),
          "codebook_matmul: every case at llama3.2-3b's widths (f32 and bf16 "
          "x, int8, int32, int64 idx) on the wgmma kernel; the padded idx "
          "rows, the ragged and the paper-MLP shapes on the CUDA-core kernel")

    rows, m_err, c_err = {}, {}, {}     # (route, dtype) -> max_abs_err
    for lbl, x, w, mask, g in mcases:
        got = m_out.pop(lbl)
        want = fwd_bwd(masked_matmul_ref, x, w, mask, g)
        m_, k_ = x.shape
        n_ = w.shape[1]
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in zip(got, want)]
        key = (_expected_route(lbl), _dtype_name(x.dtype))
        m_err[key] = max(m_err.get(key, 0.0), *errs)
        sums = _masked_abs_sums(x, w, mask, g)
        # the gap in f32 roundoffs of sum |a||b|: the f32 sums' own (for
        # f32), what a bf16 result has beyond one quantum (for bf16)
        gaps = [(_bf16_excess(a, b, s) if a.dtype == torch.bfloat16 else
                 (a - b).abs() / (F32_UNIT_ROUNDOFF * s)).nan_to_num().max()
                .item() for a, b, s in zip(got, want, sums)]
        print(f"masked_matmul {lbl} {x.dtype}: y, dx, dw max_abs_err {errs}; "
              f"gap in f32 roundoffs of sum|a||b| {gaps} (bf16: beyond one "
              f"quantum, limit {SUM_ROUNDOFFS})")
        if lbl.startswith("nonbinary"):
            # dw = round(round(x^T @ g) * mask): rounding x^T @ g twice
            # lets two summation orders differ by more than one final
            # quantum, so dw is held bitwise to the kernel's own x^T @ g
            # masked in bf16, and that product to the plain one
            xtg = masked_product(x.t(), g)
            plain_xtg = (x.float().t() @ g.float()).to(x.dtype)
            xtg_sum = x.float().abs().t() @ g.float().abs()
            over = int((_bf16_excess(got[2], want[2], sums[2])
                        > SUM_ROUNDOFFS).sum())
            print(f"masked_matmul {lbl}: dw elements beyond one quantum + "
                  f"{SUM_ROUNDOFFS} roundoffs of the plain dw: {over} of "
                  f"{got[2].numel()}; x^T@g gap "
                  f"{_bf16_excess(xtg, plain_xtg, xtg_sum).max().item()}")
            check(all(_mm_within(a, b, d, s) for a, b, d, s in
                      zip(got[:2], want[:2], (k_, n_), sums[:2]))
                  and torch.equal(got[2], xtg * mask)
                  and _mm_within(xtg, plain_xtg, m_, xtg_sum),
                  f"masked_matmul {lbl} ({m_}, {k_}, {n_}) {x.dtype}, mask "
                  f"0 or uniform in [0, 1): y, dx within tolerance of the "
                  f"plain version's autograd; dw bitwise round(x^T@g) * "
                  f"mask in bf16, x^T@g within tolerance of the plain one")
            del xtg, plain_xtg, xtg_sum
        else:
            check(all(_mm_within(a, b, d, s)
                      for a, b, d, s in zip(got, want, (k_, n_, m_), sums)),
                  f"masked_matmul {lbl} ({m_}, {k_}, {n_}) {x.dtype}: y, dx, "
                  f"dw vs the plain version's autograd within tolerance, "
                  f"max_abs_err {errs}, roundoffs of sum|a||b| {gaps}")
        del sums
        check(bool(torch.all(got[2][mask == 0] == 0)),
              f"masked_matmul {lbl}: dw exactly 0 wherever the mask is 0")
        del got, want
        big = m_ >= 4096
        reps, inner = (5, 2) if big else (15, 10)
        wm = w * mask
        n_bytes, flops = _mm_work(x, n_, 2 * w.numel() * w.element_size())
        rate = (BF16_FLOP_PER_S if x.dtype == torch.bfloat16
                else F32_FLOP_PER_S)
        bms = bound_ms(n_bytes, flops, rate)
        by = ("bytes" if n_bytes / HBM_BYTES_PER_S >= flops / rate
              else "operations")
        with torch.no_grad():
            ms = time_ms(lambda: masked_matmul(x, w, mask), reps, inner)
            pms = time_ms(lambda: masked_matmul_ref(x, w, mask), reps, inner)
            lms = time_ms(lambda: torch.matmul(x, wm), reps, inner)
            dms = kernel_device_ms(lambda: masked_matmul(x, w, mask),
                                   "masked_matmul_kernel",
                                   calls=5 if big else 100)
        print(f"kernel masked_matmul {lbl} ({m_}, {k_}, {n_}) {x.dtype} "
              f"route {_expected_route(lbl)}: "
              f"ms={ms:.6f} plain_ms={pms:.6f} matmul_ms={lms:.6f} "
              f"bound_ms={bms:.6f} ({by}) device_ms={dms} bytes={n_bytes} "
              f"flops={flops:.0f} tflops={flops / ms / 1e9:.2f}")
        if lbl in ("train_wi_f32", "train_wi_bf16"):
            rows["masked_matmul" if lbl.endswith("f32")
                 else "masked_matmul_wgmma"] = dict(
                ms=ms, plain_ms=pms, device_ms=dms, bound_ms=bms,
                bound_by=by, library_ms=lms, dtype=_dtype_name(x.dtype))
    _route_errors("masked_matmul", m_err, rows, {
        "wgmma": "masked_matmul_wgmma", "simt": "masked_matmul"})

    for lbl, x, idx, cb in ccases:
        out = c_out.pop(lbl)
        ref = codebook_matmul_ref(x, idx, cb)
        route = _codebook_route(lbl)
        m_, k_ = x.shape
        n_ = idx.shape[1]
        e = (out.float() - ref.float()).abs().max().item()
        key = (route, _dtype_name(x.dtype))
        c_err[key] = max(c_err.get(key, 0.0), e)
        abs_sum = x.float().abs() @ decode(idx, cb).abs()
        gap = (_bf16_excess(out, ref, abs_sum) if x.dtype == torch.bfloat16
               else (out - ref).abs() / (F32_UNIT_ROUNDOFF * abs_sum)
               ).nan_to_num().max().item()
        check(_mm_within(out, ref, k_, abs_sum),
              f"codebook_matmul {lbl} ({m_}, {k_}, {n_}) {x.dtype} x, "
              f"{idx.dtype} idx, k={cb.numel()}, route {route}: vs the plain "
              f"version within tolerance, max_abs_err {e}, gap in f32 "
              f"roundoffs of sum|x||c| {gap} (bf16: beyond one quantum)")
        del abs_sum
        big = m_ >= 4096
        reps, inner = (5, 2) if big else (15, 10)
        wd, xf = cb[idx.long()], x.float()
        n_bytes, flops = _mm_work(x, n_, idx.numel() * idx.element_size()
                                  + cb.numel() * 4)
        # wgmma: three bf16 products for bf16 x, six for f32 x, at the
        # bf16 peak; simt: one f32 product at the f32 CUDA-core peak
        products = (1 if route == "simt" else
                    3 if x.dtype == torch.bfloat16 else 6)
        rate = F32_FLOP_PER_S if route == "simt" else BF16_FLOP_PER_S
        bms = bound_ms(n_bytes, products * flops, rate)
        by = ("bytes" if n_bytes / HBM_BYTES_PER_S >= products * flops / rate
              else "operations")
        ms = time_ms(lambda: codebook_matmul(x, idx, cb), reps, inner)
        pms = time_ms(lambda: codebook_matmul_ref(x, idx, cb), reps, inner)
        lms = time_ms(lambda: torch.matmul(xf, wd), reps, inner)
        dms = kernel_device_ms(lambda: codebook_matmul(x, idx, cb),
                               "codebook_matmul_kernel",
                               calls=5 if big else 100)
        print(f"kernel codebook_matmul {lbl} ({m_}, {k_}, {n_}) {x.dtype} x "
              f"{idx.dtype} idx k={cb.numel()} route {route}: ms={ms:.6f} "
              f"plain_ms={pms:.6f} matmul_f32_ms={lms:.6f} "
              f"bound_ms={bms:.6f} ({by}; {products} products) "
              f"one_product_bound_ms={bound_ms(n_bytes, flops, rate):.6f} "
              f"device_ms={dms} bytes={n_bytes} flops={flops:.0f} "
              f"tflops={flops / ms / 1e9:.2f}")
        name = {"train_wi_k16_int8_padded": "codebook_matmul",
                "train_wi_k16_int8_bf16": "codebook_matmul_wgmma"}.get(lbl)
        if name:
            rows[name] = dict(ms=ms, plain_ms=pms, device_ms=dms,
                              bound_ms=bms, bound_by=by, library_ms=lms,
                              dtype=_dtype_name(x.dtype))
        del wd, xf
    _route_errors("codebook_matmul", c_err, rows, {
        "wgmma": "codebook_matmul_wgmma", "simt": "codebook_matmul"})
    del mcases, ccases, m_out, c_out
    torch.cuda.empty_cache()
    return rows, launches


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


def _fused_run(scenario, device, label, expect_backend):
    """The main path: scan_pallas with every launch counter zeroed just
    before and read just after; one fleet_aggregate launch a round, and
    none through the one-leaf wrappers."""
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.fleet_aggregate import fleet_aggregate
    from repro_torch.kernels.grad_aggregate import grad_aggregate
    from repro_torch.kernels.structured_scatter import structured_scatter
    counters = {"fleet_aggregate": fleet_aggregate,
                "grad_aggregate": grad_aggregate,
                "structured_scatter": structured_scatter,
                "fake_quant": fake_quant}
    for fn in counters.values():
        fn.launches = 0
    res = _run(scenario, "scan_pallas", device, label)
    got = {k: fn.launches for k, fn in counters.items()}
    print(f"slice {label}: launches={json.dumps(got)} per_round="
          f"{json.dumps({k: v / ROUNDS for k, v in got.items()})}")
    check(res.agg_backend == expect_backend,
          f"{label}: agg_backend == {expect_backend!r}")
    for k, n in (("fleet_aggregate", 1), ("grad_aggregate", 0),
                 ("structured_scatter", 0)):
        check(got[k] == n * ROUNDS, f"{label}: {k} launched {n} per round")
    return res, got


def _per_leaf_route(params, per_cohort, sliced: bool):
    """The round's aggregation one launch per leaf, as the engine ran it
    before the grouped kernel: masked fleets ``grad_aggregate`` on each
    >=2-D leaf over the cohorts stacked on a tier axis and the chain on
    1-D leaves; width fleets ``structured_scatter_batched`` per group of
    same-signature leaves, stacked."""
    import torch
    from repro_torch.core.aggregation import accumulate_cohort, f32, finalize
    from repro_torch.kernels.grad_aggregate import grad_aggregate
    from repro_torch.kernels.structured_scatter import (
        structured_scatter_batched)
    wn = [f32(w) for (_, _, w, _) in per_cohort]
    wd = [f32(f32(w) * f32(c)) for (_, _, w, c) in per_cohort]
    out = {}
    if sliced:
        groups: dict = {}
        for k, p in params.items():
            sig = (tuple(p.shape),
                   tuple(tuple(g[k].shape) for (g, _, _, _) in per_cohort),
                   tuple(m[k].dim() == 0 for (_, m, _, _) in per_cohort))
            groups.setdefault(sig, []).append(k)
        for (shape, _, _), ks in groups.items():
            res = structured_scatter_batched(
                [torch.stack([g[k] for k in ks]) for (g, _, _, _) in per_cohort],
                [torch.stack([m[k] for k in ks]) for (_, m, _, _) in per_cohort],
                wn, wd, out_shape=shape)
            for j, k in enumerate(ks):
                out[k] = res[j]
        return out
    for k, p in params.items():
        g_t = [g[k] for (g, _, _, _) in per_cohort]
        m_t = [m[k] for (_, m, _, _) in per_cohort]
        if p.dim() >= 2:
            ms = (torch.stack(m_t) if all(m.dim() == 0 for m in m_t) else
                  torch.stack([m.expand(p.shape) for m in m_t]))
            out[k] = grad_aggregate(torch.stack(g_t), ms, wn, w_den=wd)
            continue
        acc = ({"x": torch.zeros_like(p)},
               {"x": torch.zeros((), dtype=torch.float32, device=p.device)})
        for t, (_, _, w, count) in enumerate(per_cohort):
            acc = accumulate_cohort(acc, {"x": g_t[t]}, {"x": m_t[t]},
                                    w, count)
        out[k] = finalize(acc)["x"]
    return out


def aggregation_step(scenario, device, label: str) -> None:
    """One real round's aggregation (the cohorts' updates and masks of the
    round as ``ScanEngine`` hands them over): the grouped call bitwise the
    sequential chain and the per-leaf route, each timed with CUDA events,
    the grouped call's device time, launches and bytes bound."""
    import torch

    from repro_torch import optim
    from repro_torch.configs.paper_mlp import config
    from repro_torch.fl import ScanEngine, build_server
    from repro_torch.kernels.fleet_aggregate import fleet_aggregate
    from repro_torch.models import mlp
    srv = build_server(scenario, types.SimpleNamespace(loss_fn=mlp.loss_fn),
                       optim.sgd(1.0),
                       mlp.init(torch.Generator().manual_seed(0), config()),
                       device=device)
    eng = ScanEngine(srv, agg="pallas")
    seen = []
    fused = eng._aggregate_fused
    eng._aggregate_fused = lambda p, pc: seen.append((p, pc)) or fused(p, pc)
    eng.run(1)
    params, per_cohort = seen[0]
    before = fleet_aggregate.launches
    got = fused(params, per_cohort)
    n_launch = fleet_aggregate.launches - before
    chain = eng._aggregate_sequential(params, per_cohort)
    leaf = _per_leaf_route(params, per_cohort, eng._any_sliced)
    torch.cuda.synchronize()
    check(all(torch.equal(got[k], chain[k]) and torch.equal(leaf[k], chain[k])
              for k in params),
          f"{label}: the round's grouped aggregation == the sequential chain "
          f"== the per-leaf route (bitwise)")
    leaves = {k: (p.shape, [(g[k], m[k]) for (g, m, _, _) in per_cohort])
              for k, p in params.items()}
    n_bytes = _leaves_bytes(leaves)
    ms = time_ms(lambda: fused(params, per_cohort))
    chain_ms = time_ms(lambda: eng._aggregate_sequential(params, per_cohort))
    leaf_ms = time_ms(lambda: _per_leaf_route(params, per_cohort,
                                              eng._any_sliced))
    dms = kernel_device_ms(lambda: fused(params, per_cohort),
                           "fleet_aggregate_kernel")
    print(f"slice {label} aggregation step: leaves={len(params)} "
          f"tiers={len(per_cohort)} grouped_ms={ms:.6f} "
          f"device_ms={dms:.6f} launches={n_launch} "
          f"bound_ms={bound_ms(n_bytes):.7f} bytes={n_bytes} "
          f"chain_ms={chain_ms:.6f} per_leaf_route_ms={leaf_ms:.6f}")


def _same_params(a, b) -> float:
    import torch
    if all(torch.equal(a[k], b[k]) for k in a):
        return 0.0
    return max((a[k] - b[k]).abs().max().item() for k in a)


def profile_window(label: str, fn, n: int, per: str) -> None:
    """Where a window's time goes: host wall time of ``fn()`` (``n``
    rounds, steps or calls) against the device time of every kernel and
    copy it ran. The profiler slows the host, so the wall time here reads
    above the unprofiled one."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = device_events(prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    by_name = collections.Counter()
    for e in ev:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
    print(f"profile {label}: wall_ms_per_{per}={wall_ms / n:.3f} "
          f"device_busy_ms_per_{per}={busy_ms / n:.3f} "
          f"device_busy_share={busy_ms / wall_ms:.4f} "
          f"device_ops_per_{per}={len(ev) / n:.1f} (profiled)")
    for name, t in by_name.most_common(6):
        print(f"profile {label}: top device time {t / n:.4f} ms/{per} "
              f"{name}")


def profile_rounds(scenario, device, label: str, rounds: int = 5) -> None:
    """A profiled scan_pallas window of ``rounds`` rounds."""
    import torch

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
    profile_window(label, lambda: eng.run(rounds), rounds, "round")


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
    # the kernels line's rows: the grouped kernel stands for grad_aggregate
    # on masked and fedavg fleets, for structured_scatter on width fleets
    launches = {"grad_aggregate": 0, "structured_scatter": 0, "fake_quant": 0}

    _run(masked, "eager", device, "masked")
    ref = _run(masked, "scan", device, "masked")
    res, got = _fused_run(masked, device, "masked", "pallas")
    launches["grad_aggregate"] += got["fleet_aggregate"]
    launches["fake_quant"] += got["fake_quant"]
    check(_same_params(ref.params, res.params) == 0.0,
          "masked: scan_pallas params == scan params (bitwise)")

    _run(width, "eager", device, "width")
    ref = _run(width, "scan", device, "width")
    res, got = _fused_run(width, device, "width", "pallas_structured")
    launches["structured_scatter"] += got["fleet_aggregate"]
    launches["fake_quant"] += got["fake_quant"]
    check(_same_params(ref.params, res.params) == 0.0,
          "width: scan_pallas params == scan params (bitwise)")

    ref = _run(fedavg, "scan", device, "fedavg_fp8_ef")
    res, got = _fused_run(fedavg, device, "fedavg_fp8_ef", "pallas")
    launches["grad_aggregate"] += got["fleet_aggregate"]
    launches["fake_quant"] += got["fake_quant"]
    d = _same_params(ref.params, res.params)
    print(f"slice fedavg_fp8_ef: scan_pallas vs scan max_abs_err={d}")
    check(d <= 1e-5, "fedavg_fp8_ef: scan_pallas params == scan to 1e-5")
    fleets = (("masked", masked), ("width", width), ("fedavg_fp8_ef", fedavg))
    for label, sc in fleets:
        aggregation_step(sc, device, label)
    for label, sc in fleets:
        profile_rounds(sc, device, label)
    return launches


# -------------------------------------------------------------- client

CLIENT_ROUNDS = 60
CLIENT_FLEET = ("hub", "high", "high", "mid", "mid", "low", "low", "embedded")


def phase_client(device) -> int:
    """The per-client runtime (``runtime="client"``): the paper's
    experiment as ``examples/hetero_fl_sim.py`` runs it, then the
    256-client bench fleet per client against the cohort runtime.
    Returns fake_quant launches (counter zeroed at the start)."""
    import torch
    from repro_torch.data import make_gaussian_dataset
    from repro_torch.fl import (FleetSpec, FLScenario, LocalTraining,
                                UploadPolicy, simulate)
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.models import mlp
    noniid = FleetSpec(tiers=CLIENT_FLEET, n_samples=4000,
                       partition="dirichlet", alpha=0.5)
    val = {k: v.to(device) for k, v in make_gaussian_dataset(
        torch.Generator().manual_seed(9), 1000).items()}
    scenarios = {
        "fedsgd_all_hub": FLScenario(fleet=FleetSpec(
            tiers=("hub",) * len(CLIENT_FLEET), n_samples=4000,
            partition="dirichlet"), runtime="client"),
        "fedsgd_hetero": FLScenario(fleet=noniid, runtime="client"),
        "fedavg_hetero": FLScenario(
            fleet=noniid, runtime="client",
            local=LocalTraining(mode="fedavg", local_steps=5, local_lr=1.0)),
        "fedsgd_fp8_ef": FLScenario(
            fleet=noniid, runtime="client",
            upload=UploadPolicy(quant="fp8_e4m3", error_feedback=True)),
    }
    fake_quant.launches = 0
    for name, sc in scenarios.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = simulate(sc, CLIENT_ROUNDS, device=device)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / CLIENT_ROUNDS * 1e3
        acc = mlp.accuracy(res.params, val["x"], val["y"]).item()
        losses = res.losses
        print(f"client {name}: ms_per_round={ms:.3f} loss[1]={losses[0]:.6f} "
              f"loss[{CLIENT_ROUNDS}]={losses[-1]:.6f} val_acc={acc:.4f} "
              f"round_wall_s={res.final.round_wall_time:.6f} "
              f"upload_bytes={res.final.total_upload_bytes:.1f} "
              f"shards={[len(c.data['y']) for c in res.server.clients]}")
        check(all(l == l and abs(l) != float("inf") for l in losses),
              f"client {name}: losses finite")
        check(losses[-1] < losses[0], f"client {name}: loss falls over "
                                      f"{CLIENT_ROUNDS} rounds")
        check(acc >= 0.97, f"client {name}: val_acc {acc:.4f} >= 0.97 on "
                           f"1000 held-out samples (the reference's "
                           f"healthy run)")
    srv = simulate(scenarios["fedsgd_hetero"], 1, device=device).server
    profile_window("client fedsgd_hetero", lambda: [srv.round()
                                                    for _ in range(5)],
                   5, "round")

    fleet = FleetSpec.cycling(BENCH_TIERS, 256, samples_per_client=16)
    runs = {}
    for runtime in ("client", "cohort"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[runtime] = simulate(FLScenario(fleet=fleet, runtime=runtime), 2,
                                 device=device)
        torch.cuda.synchronize()
        print(f"client bench256 runtime={runtime}: ms_per_round="
              f"{(time.perf_counter() - t0) / 2 * 1e3:.3f} "
              f"losses={runs[runtime].losses}")
    a, b = runs["client"].params, runs["cohort"].params
    d = max((a[k] - b[k]).abs().max().item() for k in a)
    check(d <= 1e-5, f"bench256: per-client params == cohort params to 1e-5 "
                     f"after 2 rounds, max_abs_err {d}")
    return fake_quant.launches


# --------------------------------------------------------------- async

ASYNC_WINDOWS = 20


def _async_run(sc, engine: str, device, label: str):
    import torch
    from repro_torch.fl import simulate
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulate(sc, ASYNC_WINDOWS, engine=engine, device=device)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / ASYNC_WINDOWS * 1e3
    recs = res.records
    print(f"async {label} engine={engine}: ms_per_window={ms:.3f} "
          f"loss[1]={recs[0].loss:.6f} loss[{ASYNC_WINDOWS}]="
          f"{recs[-1].loss:.6f} staleness_mean="
          f"{statistics.mean(r.staleness_mean for r in recs):.4f} "
          f"staleness_max={max(r.staleness_max for r in recs)} "
          f"n_versions_live(last, max)=({recs[-1].n_versions_live}, "
          f"{max(r.n_versions_live for r in recs)}) "
          f"virtual_t={res.sim_time:.6f} agg_backend={res.agg_backend}")
    check(all(r.loss == r.loss and abs(r.loss) != float("inf") for r in recs),
          f"async {label}/{engine}: losses finite")
    check(recs[-1].loss < recs[0].loss,
          f"async {label}/{engine}: loss falls over {ASYNC_WINDOWS} windows")
    return res


def phase_async(device) -> int:
    """The async runtime on the 256-client bench fleet and its width
    twin, eager and ``scan`` (bitwise equal), then the full-buffer,
    no-discount limit against the sync-wait cohort run. Returns
    fake_quant launches (counter zeroed at the start)."""
    import torch
    from repro_torch import optim
    from repro_torch.configs.paper_mlp import config
    from repro_torch.fl import (AsyncBuffered, FleetSpec, FLScenario,
                                LocalTraining, WindowScanEngine,
                                build_server, simulate)
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.models import mlp
    fleet = FleetSpec.cycling(BENCH_TIERS, 256, samples_per_client=16)
    timing = AsyncBuffered(buffer_size=64, staleness_exp=0.5, time_jitter=0.2)
    fake_quant.launches = 0
    for label, local in (("masked", LocalTraining()),
                         ("width", LocalTraining(submodel="width"))):
        sc = FLScenario(fleet=fleet, local=local, timing=timing)
        eager = _async_run(sc, "eager", device, label)
        scan = _async_run(sc, "scan", device, label)
        check(scan.records == eager.records
              and _same_params(eager.params, scan.params) == 0.0,
              f"async {label}: scan params and records == eager (bitwise)")
        check(max(r.staleness_max for r in eager.records) > 0,
              f"async {label}: the staleness discount fires")
    n = fake_quant.launches
    srv = build_server(FLScenario(fleet=fleet, timing=timing),
                       types.SimpleNamespace(loss_fn=mlp.loss_fn), optim.sgd(1.0),
                       mlp.init(torch.Generator().manual_seed(0), config()),
                       device=device)
    eng = WindowScanEngine(srv)
    eng.run(2)
    profile_window("async masked scan", lambda: eng.run(5), 5, "window")

    sync = simulate(FLScenario(fleet=fleet), 3, device=device)
    full = simulate(FLScenario(fleet=fleet, timing=AsyncBuffered(
        buffer_size=256, staleness_exp=0.0)), 3, engine="scan",
        device=device)
    d = max((sync.params[k] - full.params[k]).abs().max().item()
            for k in sync.params)
    print(f"async full buffer, no discount vs sync-wait: losses "
          f"{full.losses} vs {sync.losses}, params max_abs_err={d}")
    check(d <= 1e-6, f"async full buffer, no discount == sync-wait cohort "
                     f"run to 1e-6 in params, max_abs_err {d}")
    check(n > 0, f"async: fake_quant launched {n} times on the main path")
    return n


# --------------------------------------------------------------- serve

SERVE_TIERS = ("hub", "high", "mid", "low", "embedded")


def phase_serve(device) -> int:
    """The LM serve path on the full config; returns fake_quant launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.compression import DEVICE_TIERS
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.launch.serve import serve
    from repro_torch.models import get_model
    batch, prompt, gen = 4, 64, 32
    cfg = get_config(LM_ARCH)
    params = get_model(cfg).init(0, device=device)
    check({k: tuple(v.shape) for k, v in params.items()}
          == _lm_leaf_shapes(cfg),
          f"{LM_ARCH} full config: the params' leaves are the table the "
          f"fake_quant checks ran on")
    n_params = sum(p.numel() for p in params.values())
    print(f"serve {LM_ARCH}: layers={cfg.num_layers} params={n_params} "
          f"dtype={cfg.dtype} batch={batch} prompt={prompt} gen={gen}")
    serve(cfg, "mid", batch=batch, prompt_len=8, gen=2, params=params,
          device=device)                      # warm-up
    total = 0
    for tier in SERVE_TIERS:
        quantized = DEVICE_TIERS[tier].quant_em()[0] > 0
        torch.cuda.reset_peak_memory_stats()
        fake_quant.launches = 0
        res = serve(cfg, tier, batch=batch, prompt_len=prompt, gen=gen,
                    params=params, device=device)
        n = fake_quant.launches
        total += n
        tok_s = gen * batch / res["decode_s"]
        print(f"serve {tier}: compress_s={res['compress_s']:.6f} "
              f"prefill_s={res['prefill_s']:.6f} "
              f"decode_s={res['decode_s']:.6f} decode_tokens_per_s="
              f"{tok_s:.3f} fake_quant_launches={n} peak_mem_gb="
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} "
              f"sample={res['tokens'][0, :8].tolist()}")
        check(bool(torch.isfinite(res["prefill_logits"]).all()
                   and torch.isfinite(res["replay_logits"]).all()),
              f"serve {tier}: logits finite")
        check(n == (10 if quantized else 0),
              f"serve {tier}: fake_quant launched {n} times "
              f"(10 quantized leaves, 0 for the hub)")
    profile_window("serve low", lambda: serve(
        cfg, "low", batch=batch, prompt_len=prompt, gen=gen, params=params,
        device=device), 1, "call")
    del params, res
    torch.cuda.empty_cache()

    # prefill vs the decode replay of the same prompt, in f32 at 2 layers
    # of full width: both are the same f32 math (TF32 off) summed in other
    # orders — batched GEMMs and chunked attention against per-token
    # GEMVs and the ring cache — which moves logits of O(1) by ~1e-6; a
    # wrong position, mask or cache slot moves them by O(1)
    cfg2 = cfg.replace(num_layers=2, dtype="float32")
    res = serve(cfg2, "mid", batch=batch, prompt_len=prompt, gen=1,
                device=device)
    a, b = res["replay_logits"], res["prefill_logits"]
    e = (a - b).abs().max().item()
    check(torch.allclose(a, b, rtol=1e-3, atol=1e-4),
          f"serve f32 2-layer: decode replay == prefill last-token logits "
          f"(rtol 1e-3, atol 1e-4), max_abs_err {e}, "
          f"max|logit| {b.abs().max().item():.3f}")
    return total


# --------------------------------------------------------------- train

def phase_train(device) -> dict:
    """The tier-loop LM train step; returns launches of the main run."""
    import torch
    from repro_torch import optim
    from repro_torch.configs import ShapeConfig, get_config, get_smoke_config
    from repro_torch.core.compression import (DEVICE_TIERS,
                                              default_tier_plans,
                                              magnitude_mask)
    from repro_torch.core.steps import make_hetero_train_step
    from repro_torch.data.synthetic import make_train_batch
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.train import train
    from repro_torch.models import get_model

    # the card's f32 step against the port's CPU path, smoke config
    cfg = get_smoke_config(LM_ARCH).replace(use_flash=True)
    model = get_model(cfg)
    init = model.init(torch.Generator().manual_seed(0))
    runs = {}
    routes = flash_attention.route_launches
    for r in routes:
        routes[r] = 0
    for dev in ("cpu", device):
        opt = optim.sgd(0.5)
        step = make_hetero_train_step(model, opt, default_tier_plans(4))
        params = {k: v.to(dev) for k, v in init.items()}
        st = dict(params=params, opt=opt.init(params),
                  step=torch.zeros((), dtype=torch.int32, device=dev))
        losses = []
        for i in range(2):
            b = make_train_batch(cfg, ShapeConfig("t", 64, 8, "train"),
                                 n_tiers=4, seed=1, index=i)
            st, m = step(st, {k: v.to(dev) for k, v in b.items()})
            losses.append(m["loss"].item())
        runs[str(dev)] = (losses, st["params"])
    smoke_routes = dict(routes)
    (lc, pc), (lg, pg) = runs["cpu"], runs[str(device)]
    e = max((pg[k].cpu() - pc[k]).abs().max().item() for k in pc)
    print(f"train smoke f32: cpu losses={lc} cuda losses={lg} "
          f"params max_abs_err={e} flash launches per route="
          f"{json.dumps(smoke_routes)}")
    smoke_n = cfg.num_layers * 4 * 2
    check(smoke_routes == {"wgmma": 0, "simt": smoke_n},
          f"train smoke f32: flash_attention launched {smoke_n} times, all "
          f"on the simt kernel ({cfg.num_layers} layers x 4 tiers x 2 "
          f"steps on the card)")
    check(all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(lg, lc)),
          "train smoke f32: card losses == CPU losses to rtol 1e-4")
    check(e <= 1e-5, f"train smoke f32: card params == CPU params to atol "
                     f"1e-5 after 2 SGD steps, max_abs_err {e}")

    # the main path: full width, cut to TRAIN_LAYERS layers, bf16, flash
    cfg = get_config(LM_ARCH).replace(num_layers=TRAIN_LAYERS, use_flash=True)
    batch, seq, n_tiers = 8, 1024, 4
    print(f"train {LM_ARCH}: layers={cfg.num_layers} (cut from 28) "
          f"d_model={cfg.d_model} dtype={cfg.dtype} use_flash=True "
          f"tiers={n_tiers} batch={batch} seq={seq} steps={TRAIN_STEPS}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    for r in routes:
        routes[r] = 0
    fake_quant.launches = 0
    res = train(cfg, steps=TRAIN_STEPS, batch=batch, seq=seq,
                n_tiers=n_tiers, lr=3e-4, warmup=2, seed=0, device=device,
                log_every=1)
    main_routes = dict(routes)
    # flash_attention_simt: the smoke f32 step's launches (the main run
    # must have none)
    got = {"flash_attention": flash_attention.launches,
           "flash_attention_wgmma": main_routes["wgmma"],
           "flash_attention_simt": smoke_routes["simt"],
           "fake_quant": fake_quant.launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses, secs = res["losses"], res["sec_per_step"]
    steady = secs[1:] if len(secs) > 1 else secs
    sps = sum(steady) / len(steady)
    print(f"train: losses={losses} tier_losses (hub, high, mid, low)="
          f"{res['tier_losses']}")
    print(f"train: sec_per_step={secs} "
          f"mean_sec_per_step(steps 2..{TRAIN_STEPS})={sps:.6f} "
          f"tokens_per_s={batch * seq / sps:.3f} peak_mem_gb={peak:.3f} "
          f"launches={json.dumps(got)}")
    check(all(l == l and abs(l) != float("inf") for l in losses),
          "train: losses finite")
    low = DEVICE_TIERS["low"]
    keep = {k: magnitude_mask(res["state"]["params"][k], low.density)
            .mean().item() for k in ("layers.ln1", "layers.ln2")}
    print(f"train: fraction of the stacked norm scales (all 1.0 at init, "
          f"so all kept) that the low tier keeps after step "
          f"{TRAIN_STEPS}: {keep}")
    # warmup_cosine gives lr 0 at step 0, so step 2's loss is step 1's
    # model. AdamW's first nonzero updates then make every tier's loss
    # jump at step 3, the uncompressed hub's too: at this width the
    # reference does the same (tests/test_torch_lm_steps.py::
    # test_adamw_loss_jump_at_full_width_matches_reference), and so does
    # the run without flash below. Training must then lower the mean
    # loss and each tier's at every later step.
    curves = {"mean": losses, **dict(zip(("hub", "high", "mid", "low"),
                                         zip(*res["tier_losses"])))}
    check(all(c[4] < c[3] < c[2] for c in curves.values()),
          f"train: the mean loss and each tier's fall at each of steps 4 "
          f"and 5: " + ", ".join(f"{k} {c[2]:.4f} -> {c[3]:.4f} -> "
                                 f"{c[4]:.4f}" for k, c in curves.items()))
    layers_tiers = cfg.num_layers * n_tiers
    check(got["flash_attention"] == layers_tiers * TRAIN_STEPS,
          f"train: flash_attention launched {layers_tiers} per step "
          f"({cfg.num_layers} layers x {n_tiers} tiers, forward only)")
    check(main_routes == {"wgmma": layers_tiers * TRAIN_STEPS, "simt": 0},
          f"train: every flash_attention launch on the wgmma kernel "
          f"({layers_tiers} per step), none on simt: {main_routes}")
    check(got["fake_quant"] == 30 * TRAIN_STEPS,
          "train: fake_quant launched 30 per step (3 quantized tiers x 10 "
          "leaves)")
    # one more step of the same run, profiled
    opt = optim.adamw(optim.warmup_cosine(3e-4, 2, TRAIN_STEPS))
    step = make_hetero_train_step(get_model(cfg), opt,
                                  default_tier_plans(n_tiers))
    b = make_train_batch(cfg, ShapeConfig("t", seq, batch, "train"),
                         n_tiers=n_tiers, seed=0, index=TRAIN_STEPS)
    b = {k: v.to(device) for k, v in b.items()}
    profile_window("train step", lambda: step(res["state"], b), 1, "step")
    del res, step, b
    # the same run with the plain attention in place of the kernel
    plain = train(cfg.replace(use_flash=False), steps=TRAIN_STEPS,
                  batch=batch, seq=seq, n_tiers=n_tiers, lr=3e-4, warmup=2,
                  seed=0, device=device, log_every=TRAIN_STEPS)
    e = max(abs(a - b) / abs(b) for a, b in zip(losses, plain["losses"]))
    print(f"train without flash: losses={plain['losses']} tier_losses="
          f"{plain['tier_losses']}")
    check(e <= 1e-3, f"train: the flash run's losses == the run without "
                     f"flash to rtol 1e-3 (bf16 attention rounding), max "
                     f"rel err {e}")
    return got


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
        entry = ""
        for line in build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                # the kernel's (mangled) name and template arguments:
                # Lb1E true, Lb0E false, Li128E 128, 13__nv_bfloat16 bf16
                mangled = line.split("'")[1]
                at = mangled.find(f"{name}_kernel")
                entry = mangled[at:at + 56] if at >= 0 else mangled[-56:]
            elif "registers" in line or "spill" in line:
                print(f"ptxas {name} {entry}: {line.strip()}")

    device = torch.device("cuda")
    phases = [("kernels", lambda: phase_kernels(device)),
              ("lm kernels", lambda: phase_lm_kernels(device)),
              ("matmul kernels", lambda: phase_matmul_kernels(device)),
              ("slice", lambda: phase_slice(device)),
              ("client", lambda: phase_client(device)),
              ("async", lambda: phase_async(device)),
              ("serve", lambda: phase_serve(device)),
              ("train", lambda: phase_train(device))]
    out = {}
    try:
        for name, run in phases:
            t_phase = time.perf_counter()
            out[name] = run()
            print(f"phase {name}: {time.perf_counter() - t_phase:.1f} s")
    except CheckFailed as e:
        print(f"CHECK FAILED: {e}", file=sys.stderr)
        return 1
    rows = {**out["kernels"], **out["lm kernels"], **out["matmul kernels"][0]}
    # each main path's launches, its counters zeroed just before it
    launches = dict(out["slice"])
    launches["fake_quant"] += (out["client"] + out["async"] + out["serve"]
                               + out["train"]["fake_quant"])
    launches.update(out["matmul kernels"][1])
    # the kernels line has one entry per route of flash_attention,
    # masked_matmul and codebook_matmul: the f32 train row on the CUDA
    # cores (flash: the smoke f32 train step's launches; codebook: idx rows
    # TMA refuses), the bf16 train row on the tensor cores
    launches["flash_attention"] = out["train"]["flash_attention_simt"]
    launches["flash_attention_wgmma"] = out["train"]["flash_attention_wgmma"]
    launches["masked_matmul"] = launches.pop("masked_matmul_simt")
    launches["codebook_matmul"] = launches.pop("codebook_matmul_simt")
    del launches["codebook_matmul_calls"]
    print(f"main-path launches (FL slice + client + async + serve + train, "
          f"matmul entry points): {json.dumps(launches)}")
    kernels = []
    for name, replaces in (
            ("grad_aggregate",
             "src/repro/kernels/grad_aggregate/kernel.py:51"),
            ("structured_scatter",
             "src/repro/kernels/structured_scatter/kernel.py:142"),
            ("fake_quant", "src/repro/kernels/fake_quant/kernel.py:54"),
            ("flash_attention",
             "src/repro/kernels/flash_attention/kernel.py:72"),
            ("flash_attention_wgmma",
             "src/repro/kernels/flash_attention/kernel.py:72"),
            ("masked_matmul",
             "src/repro/kernels/masked_matmul/kernel.py:36"),
            ("masked_matmul_wgmma",
             "src/repro/kernels/masked_matmul/kernel.py:36"),
            ("codebook_matmul",
             "src/repro/kernels/codebook_matmul/kernel.py:40"),
            ("codebook_matmul_wgmma",
             "src/repro/kernels/codebook_matmul/kernel.py:40")):
        r = rows[name]
        # one grouped kernel stands for both aggregation kernels
        source = ("fleet_aggregate" if name in ("grad_aggregate",
                                                "structured_scatter")
                  else name.removesuffix("_wgmma"))
        if launches[name] <= 0:
            print(f"CHECK FAILED: {name} never launched on its main path",
                  file=sys.stderr)
            return 1
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{source}.cu",
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "device_ms": r["device_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r.get("bound_by", "bytes"),
                        "library_ms": r.get("library_ms")})
    print(json.dumps({"kernels": kernels}))
    # the number of devices this script drives, whatever the host has
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
