"""Where the wgmma codebook_matmul kernel's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.codebook_matmul.ablation

Compiles ``csrc/codebook_matmul.cu`` as it is and two copies with one
piece of work changed, then times each one's wgmma route with CUDA
events (median of windows of calls) in the order kernel, no_decode,
one_term, kernel, for bf16 and f32 x at llama3.2-3b's MLP widths: x
(8192, 3072) and (256, 3072) @ idx (3072, 8192) int8, k = 16.

- ``kernel``: the source as it is;
- ``no_decode``: the decode warps release each stage without looking up
  an index or writing a B tile, so the products read stale tiles: TMA
  and the tensor cores alone;
- ``one_term``: only the x1 c1 product is issued (the route issues three
  for bf16 x, six for f32 x).

Each line gives ms and TFLOP/s of the products the variant issues; the
``kernel`` lines also give the largest error against the plain version.
``torch.matmul(x.float(), codebook[idx])`` (the f32 product the function
is) and the CUDA-core route, on a copy of idx whose rows TMA refuses,
are timed the same way as yardsticks. The copies exist only to measure:
the port runs the source as it is. Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.codebook_matmul import codebook_matmul
from repro_torch.kernels.codebook_matmul.ops import bind, launch_wgmma
from repro_torch.kernels.codebook_matmul.ref import codebook_matmul_ref
from repro_torch.kernels.flash_attention.ablation import time_ms

SHAPES = {"train": (8192, 3072, 8192), "serve": (256, 3072, 8192)}
ORDER = ("kernel", "no_decode", "one_term", "kernel")
PRODUCTS = {torch.bfloat16: 3, torch.float32: 6}


def _variants() -> dict[str, str]:
    src = (build.CSRC / "codebook_matmul.cu").read_text()
    stores = "for (int u = 0; u < PER; ++u) {\n        const int q = t + u"
    terms = "for (int tb = 0; pa + tb < 3; ++tb) {"
    out = {"kernel": src,
           "no_decode": src.replace(stores, stores.replace("< PER", "< 0")),
           "one_term": src.replace(terms, terms.replace("< 3", "< 1"))}
    for name, v in out.items():
        if name != "kernel" and v == src:
            raise RuntimeError(f"ablation {name}: the substitution no longer "
                               f"matches csrc/codebook_matmul.cu")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ablation: no CUDA device")
    fns = {name: bind(lib, "wgmma") for name, lib in
           build.build_variants("codebook_matmul", _variants()).items()}
    gen = torch.Generator(device="cuda").manual_seed(6)
    cb = torch.randn(16, generator=gen, device="cuda").sort().values
    for label, (m, k, n) in SHAPES.items():
        idx = torch.randint(0, 16, (k, n), generator=gen, device="cuda",
                            dtype=torch.int8)
        # rows of n + 4 bytes: TMA refuses them, the CUDA-core route reads
        # them 4 at a time
        padded = torch.zeros((k, n + 4), dtype=torch.int8, device="cuda")
        padded = padded[:, :n].copy_(idx)
        w = cb[idx.long()]
        reps, inner = (5, 3) if m >= 4096 else (15, 20)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            ref = codebook_matmul_ref(x, idx, cb).float()
            out = torch.empty((m, n), dtype=dtype, device="cuda")
            flops = 2.0 * m * k * n
            for name in ORDER:
                def call(fn=fns[name]):
                    rc = launch_wgmma(x, idx, cb, out, fn)
                    if rc:
                        raise RuntimeError(f"{name}: launch failed, code {rc}")
                call()
                torch.cuda.synchronize()
                ms = time_ms(call, reps, inner)
                issued = 1 if name == "one_term" else PRODUCTS[dtype]
                err = (f" max_abs_err={(out.float() - ref).abs().max().item()}"
                       if name == "kernel" else "")
                print(f"ablation {label} {str(dtype)[6:]} {name}: ms={ms:.6f} "
                      f"tflops_issued={issued * flops / ms / 1e9:.1f}{err}")
            lib_ms = time_ms(lambda: torch.matmul(x.float(), w), reps, inner)
            simt_ms = time_ms(lambda: codebook_matmul(x, padded, cb), reps,
                              inner)
            print(f"ablation {label} {str(dtype)[6:]} matmul_f32: "
                  f"ms={lib_ms:.6f}; simt route: ms={simt_ms:.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
