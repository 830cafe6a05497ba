"""Public wrapper of the codebook_matmul CUDA kernel
(``csrc/codebook_matmul.cu``): ``y = x @ codebook[idx]`` with f32
accumulation, forward only (the reference's wrapper has no VJP either).
A CUDA tensor launches the kernel or raises; a CPU tensor takes the
plain version in ``ref.py``. There is no fallback from one to the other.

Indices are meant to lie in [0, n_codes), as every producer in the repo
makes them (``assign_codebook``). The kernel takes int8 or int32;
int64 indices (what ``assign_codebook`` returns) are narrowed here,
explicitly, to int8 when ``n_codes <= 128`` and to int32 otherwise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.codebook_matmul.ref import codebook_matmul_ref
from repro_torch.kernels.masked_matmul.ops import (as_unit_strided,
                                                  unit_strided)

MAX_CODES = 256
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_IDX_DTYPES = {torch.int8: 0, torch.int32: 1}


def _bind(lib):
    fn = lib.codebook_matmul_launch
    fn.argtypes = ([ctypes.c_int] * 2
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 2
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def narrow_indices(idx: torch.Tensor, n_codes: int) -> torch.Tensor:
    """int8 / int32 indices as given; int64 narrowed to the smallest
    type the kernel takes that holds [0, n_codes)."""
    if idx.dtype in _IDX_DTYPES:
        return idx
    if idx.dtype != torch.int64:
        raise TypeError(f"codebook_matmul takes int8, int32 or int64 "
                        f"indices, got {idx.dtype}")
    return idx.to(torch.int8 if n_codes <= 128 else torch.int32)


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
    fn = _bind(load("codebook_matmul"))
    with torch.cuda.device(x.device):
        rc = fn(_X_DTYPES[x.dtype], _IDX_DTYPES[idx.dtype], x.data_ptr(),
                x.stride(0), x.stride(1), idx.data_ptr(), idx.stride(0),
                idx.stride(1), codebook.data_ptr(), n_codes, out.data_ptr(),
                m, n, k, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"codebook_matmul kernel launch failed: "
                           f"cudaError {rc}")
    codebook_matmul.launches += 1
    return out


codebook_matmul.launches = 0
