"""Where the wgmma flash_attention kernel's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.ablation

Compiles ``csrc/flash_attention.cu`` as it is and two copies with one
piece of work changed, then times each one's wgmma route with CUDA events
(median of 15 windows of 20 calls) in the order kernel, fast_exp,
single_p, kernel, at llama3.2-3b's train shape (B 2, T = S 1024, 24 / 8
heads, hd 128), granite-3-2b's (32 / 8 heads, hd 64) and a 4096-token
llama shape, all bf16 and causal:

- ``kernel``: the source as it is;
- ``fast_exp``: ``__expf`` (one ex2.approx) in place of ``expf``;
- ``single_p``: the lo P V product dropped, so P is rounded once to bf16.

Each line also counts the outputs outside the port's bf16 check (one
bf16 quantum of the plain version's f32 result, plus 2e-5), and
``scaled_dot_product_attention`` is timed the same way as the yardstick.
The copies exist only to measure: the port runs the source as it is.
Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import math
import statistics

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SHAPES = {"train": (2, 1024, 1024, 24, 8, 128),
          "granite": (2, 1024, 1024, 32, 8, 64),
          "t4096": (1, 4096, 4096, 24, 8, 128)}
ORDER = ("kernel", "fast_exp", "single_p", "kernel")


def _variants() -> dict[str, str]:
    src = (build.CSRC / "flash_attention.cu").read_text()
    out = {"kernel": src,
           "fast_exp": src.replace("expf(", "__expf("),
           "single_p": "\n".join(line for line in src.splitlines()
                                 if "plo + 4 * kk" not in line)}
    for name, v in out.items():
        if name != "kernel" and v == src:
            raise RuntimeError(f"ablation {name}: the substitution no longer "
                               f"matches csrc/flash_attention.cu")
    return out


def _launchers(variants: dict[str, str]) -> dict:
    """The variants built and their wgmma entry points bound."""
    fns = {}
    for name, lib in build.build_variants("flash_attention",
                                          variants).items():
        fn = lib.flash_attention_wgmma_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ablation: no CUDA device")
    fns = _launchers(_variants())
    gen = torch.Generator(device="cuda").manual_seed(5)
    for label, (b, t, s, h, hkv, hd) in SHAPES.items():
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16)
                   for shape in ((b, t, h, hd), (b, s, hkv, hd),
                                 (b, s, hkv, hd)))
        ref = flash_attention_ref(q.float(), k.float(), v.float())
        quantum = torch.ldexp(torch.ones_like(ref), torch.frexp(ref)[1] - 8)
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        for name in ORDER:
            def call(fn=fns[name]):
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, t, s, h, hkv, hd, 1, 0, 0,
                        1.0 / math.sqrt(hd), stream)
                if rc:
                    raise RuntimeError(f"{name}: launch failed, code {rc}")
            call()
            torch.cuda.synchronize()
            outside = int(((out.float() - ref).abs() > quantum + 2e-5).sum())
            print(f"ablation {label} {name}: ms={time_ms(call):.6f} "
                  f"outside_bf16_check={outside} of {out.numel()}")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = time_ms(lambda: torch.nn.functional
                        .scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True,
                                                      enable_gqa=True))
        print(f"ablation {label} sdpa: ms={sdpa:.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
