"""Public wrapper of the codebook_matmul CUDA kernels
(``csrc/codebook_matmul.cu``): ``y = x @ codebook[idx]`` with f32
accumulation, forward only (the reference's wrapper has no VJP either).
CPU tensors take the plain version in ``ref.py``; CUDA tensors launch a
kernel or raise.

Where a CUDA call goes (:func:`route`): x (f32 or bf16) and idx that TMA
can describe take the tensor-core kernel (``"wgmma"``: each codeword,
and f32 x, split into exact bf16 terms), everything else the CUDA-core
kernel (``"simt"``). Neither falls back to the other or to the plain
version. ``codebook_matmul.launches`` counts calls that launched,
``codebook_matmul.route_launches`` the same per route.

Indices are meant to lie in [0, n_codes), as every producer in the repo
makes them (``assign_codebook``). The kernels take int8 or int32;
int64 indices (what ``assign_codebook`` returns) are narrowed here,
explicitly, to int8 when ``n_codes <= 128`` and to int32 otherwise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.codebook_matmul.ref import codebook_matmul_ref
from repro_torch.kernels.masked_matmul.ops import (as_unit_strided,
                                                  launch_error, sm_count,
                                                  tma_ok, unit_strided,
                                                  wgmma_plan)

MAX_CODES = 256
ROUTES = ("simt", "wgmma")
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_IDX_DTYPES = {torch.int8: 0, torch.int32: 1}
_PTR, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def bind(lib, route: str):
    """The C entry point of ``route`` in the loaded library ``lib``, with
    its argument types set."""
    if route == "wgmma":
        fn = lib.codebook_matmul_wgmma_launch
        fn.argtypes = ([_INT, _PTR, _LL, _LL] * 2
                       + [_PTR, _INT, _PTR, _PTR, _LL, _PTR, _LL, _PTR]
                       + [_INT] * 5 + [_PTR])
    else:
        fn = lib.codebook_matmul_launch
        fn.argtypes = ([_INT] * 2 + [_PTR, _LL, _LL] * 2
                       + [_PTR, _INT, _PTR] + [_INT] * 3 + [_PTR])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _launcher(route: str):
    """The route's C entry point, built and bound once."""
    return bind(load("codebook_matmul"), route)


def narrow_indices(idx: torch.Tensor, n_codes: int) -> torch.Tensor:
    """int8 / int32 indices as given; int64 narrowed to the smallest
    type the kernel takes that holds [0, n_codes)."""
    if idx.dtype in _IDX_DTYPES:
        return idx
    if idx.dtype != torch.int64:
        raise TypeError(f"codebook_matmul takes int8, int32 or int64 "
                        f"indices, got {idx.dtype}")
    return idx.to(torch.int8 if n_codes <= 128 else torch.int32)


def route(x: torch.Tensor, idx: torch.Tensor) -> str:
    """The kernel for ``x @ codebook[idx]``, idx as the kernels take it
    (int8 or int32, after :func:`narrow_indices`): ``"wgmma"`` for f32
    or bf16 x and idx that TMA can describe (``masked_matmul``'s
    :func:`tma_ok`) with no empty dimension; ``"simt"`` for everything
    else."""
    if (x.dtype not in _X_DTYPES or idx.dtype not in _IDX_DTYPES
            or 0 in x.shape or 0 in idx.shape):
        return "simt"
    return "wgmma" if tma_ok(x) and tma_ok(idx) else "simt"


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def launch_wgmma(x, idx, codebook, out, fn=None) -> int:
    """One launch of the wgmma route (``fn``: its C entry point, the
    built one by default) into ``out``, with its workspaces and tile
    plan: f32 x's bf16 planes, row-major index bytes unless idx is int8
    with unit stride along N, split-K partials when the plan splits K.
    Returns the C entry's code."""
    m, k = x.shape
    n = idx.shape[1]
    index = x.device.index
    bn, splits = wgmma_plan(m, n, k, sm_count(
        torch.cuda.current_device() if index is None else index))
    xs = ids = ws = None
    ldk, ldn = _round_up(k, 8), _round_up(n, 16)
    if x.dtype == torch.float32:
        xs = torch.empty((3, m, ldk), dtype=torch.bfloat16, device=x.device)
    if idx.dtype != torch.int8 or idx.stride(1) != 1:
        ids = torch.empty((k, ldn), dtype=torch.uint8, device=x.device)
    if splits > 1:
        ws = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()
    return (fn or _launcher("wgmma"))(
        _X_DTYPES[x.dtype], x.data_ptr(), x.stride(0), x.stride(1),
        _IDX_DTYPES[idx.dtype], idx.data_ptr(), idx.stride(0), idx.stride(1),
        codebook.data_ptr(), codebook.shape[0], out.data_ptr(), ptr(xs), ldk,
        ptr(ids), ldn, ptr(ws), m, n, k, bn, splits,
        torch.cuda.current_stream(x.device).cuda_stream)


def codebook_matmul(x: torch.Tensor, idx: torch.Tensor,
                    codebook: torch.Tensor) -> torch.Tensor:
    """y = x @ codebook[idx]; x: (M, K) f32 or bf16, idx: (K, N) integer
    codeword ids, codebook: (n_codes,) f32 with n_codes <= 256 on the
    card. Returns (M, N) in x's dtype."""
    if x.dim() != 2 or idx.dim() != 2 or codebook.dim() != 1 \
            or x.shape[1] != idx.shape[0]:
        raise ValueError(f"codebook_matmul takes x (M, K), idx (K, N) and a "
                         f"1-D codebook, got {tuple(x.shape)}, "
                         f"{tuple(idx.shape)}, {tuple(codebook.shape)}")
    devs = {x.device, idx.device, codebook.device}
    if devs == {torch.device("cpu")}:
        return codebook_matmul_ref(x, idx, codebook)
    if len(devs) != 1 or x.device.type != "cuda":
        raise ValueError(f"codebook_matmul takes CPU or CUDA tensors on one "
                         f"device, got {sorted(map(str, devs))}")
    n_codes = codebook.shape[0]
    if x.dtype not in _X_DTYPES or codebook.dtype != torch.float32:
        raise TypeError(f"codebook_matmul takes float32 or bfloat16 x and a "
                        f"float32 codebook, got {x.dtype}/{codebook.dtype}")
    if not 1 <= n_codes <= MAX_CODES:
        raise ValueError(f"codebook_matmul takes 1..{MAX_CODES} codewords, "
                         f"got {n_codes}")
    idx = narrow_indices(idx, n_codes)
    if not (unit_strided(x) and unit_strided(idx)
            and codebook.is_contiguous()):
        raise ValueError("codebook_matmul takes row- or column-major x and "
                         "idx and a contiguous codebook")
    x, idx = as_unit_strided(x), as_unit_strided(idx)
    m, k = x.shape
    n = idx.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    r = route(x, idx)
    with torch.cuda.device(x.device):
        if r == "wgmma":
            rc = launch_wgmma(x, idx, codebook, out)
        else:
            rc = _launcher("simt")(
                _X_DTYPES[x.dtype], _IDX_DTYPES[idx.dtype], x.data_ptr(),
                x.stride(0), x.stride(1), idx.data_ptr(), idx.stride(0),
                idx.stride(1), codebook.data_ptr(), n_codes, out.data_ptr(),
                m, n, k, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"codebook_matmul {r} kernel launch failed: "
                           f"{launch_error(rc)}")
    codebook_matmul.launches += 1
    codebook_matmul.route_launches[r] += 1
    return out


codebook_matmul.launches = 0
codebook_matmul.route_launches = {r: 0 for r in ROUTES}
