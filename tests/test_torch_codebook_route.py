"""Where a codebook_matmul call goes, and why the tensor-core kernel keeps
the reference's f32 numbers. Runs on the CPU and imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_codebook_route.py

``route`` is a pure function of the tensors, so it is tested here on CPU
tensors. The wgmma kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py); its arithmetic is emulated here in
f32 (``ref.wgmma_emulation``): each codeword split into three exact bf16
terms, f32 x split the same way, the kernel's products added into one
f32 accumulator per 16-deep K step. The reference computes
``x.astype(f32) @ codebook[idx]`` in f32; the port's bars are rtol 1e-4 /
atol 1e-4 x sqrt(K) for f32 x and one bf16 quantum plus 16 f32 roundoffs
of sum |x||c| for bf16 x.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.compression.clustering import (assign_codebook,
                                                     kmeans_codebook)
from repro_torch.kernels.codebook_matmul import codebook_matmul
from repro_torch.kernels.codebook_matmul.ops import narrow_indices, route
from repro_torch.kernels.codebook_matmul.ref import (codebook_matmul_ref,
                                                     decode, split_terms,
                                                     wgmma_emulation)

BF16, F32 = torch.bfloat16, torch.float32
F32_MAX = float(np.finfo(np.float32).max)
SUM_ROUNDOFFS = 16      # f32 roundoffs of sum |x||c| allowed between orders


def _offset(shape, dtype, elems):
    """A zero tensor of ``shape``, ``elems`` elements into its buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + elems, dtype=dtype)[elems:].view(shape)


@pytest.mark.parametrize("case,want", [
    ("f32", "wgmma"), ("bf16", "wgmma"), ("bf16_int32", "wgmma"),
    ("f32_x_col_major", "wgmma"), ("idx_col_major", "wgmma"),
    ("one_row", "wgmma"),
    ("f32_x_base_misaligned", "simt"), ("bf16_x_base_misaligned", "simt"),
    ("f32_row_not_16_bytes", "simt"), ("int8_row_not_16_bytes", "simt"),
    ("x_strided_view", "simt"), ("int64_not_narrowed", "simt"),
    ("f16_x", "simt"), ("empty_k", "simt"), ("single_column_k", "simt")])
def test_route(case, want):
    """The kernel a CUDA call takes is a function of dtypes, shapes,
    strides and alignment alone: TMA needs 16-byte aligned bases, one
    unit stride and the other a positive multiple of 16 bytes, for x
    (f32 or bf16) and for the int8 / int32 indices."""
    x, i8 = torch.zeros((136, 192)), torch.zeros((192, 160), dtype=torch.int8)
    ops = {
        "f32": (x, i8),
        "bf16": (x.to(BF16), i8),
        "bf16_int32": (x.to(BF16), i8.int()),
        "f32_x_col_major": (torch.zeros((192, 136)).t(), i8),
        "idx_col_major": (x, torch.zeros((160, 192), dtype=torch.int8).t()),
        "one_row": (torch.zeros((1, 192)), i8),
        "f32_x_base_misaligned": (_offset((136, 192), F32, 1), i8),
        "bf16_x_base_misaligned": (_offset((136, 192), BF16, 2), i8),
        "f32_row_not_16_bytes": (torch.zeros((130, 257)),
                                 torch.zeros((257, 160), dtype=torch.int8)),
        "int8_row_not_16_bytes": (x, torch.zeros((192, 129),
                                                 dtype=torch.int8)),
        "x_strided_view": (torch.zeros((136, 384))[:, ::2], i8),
        "int64_not_narrowed": (x, i8.long()),
        "f16_x": (x.half(), i8),
        "empty_k": (torch.zeros((8, 0)), torch.zeros((0, 16),
                                                     dtype=torch.int8)),
        "single_column_k": (torch.zeros((8, 1)),
                            torch.zeros((1, 16), dtype=torch.int8)),
    }[case]
    assert route(*ops) == want


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 16, (64, 32)).astype(np.int8))
    cb = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    before = dict(codebook_matmul.route_launches), codebook_matmul.launches
    assert torch.equal(codebook_matmul(x, idx, cb),
                       codebook_matmul_ref(x, idx, cb))
    assert (dict(codebook_matmul.route_launches),
            codebook_matmul.launches) == before


def _exact_sum(terms):
    return sum(t.double() for t in terms)


def test_split_reproduces_every_codeword_over_the_normal_range():
    """Three bf16 terms give back every f32 with |v| >= 2^-110 exactly
    (random bit patterns over the whole range, both signs), and the
    edges: +-0, the largest f32 and -3.4e38, whose first term rounded to
    nearest would be inf and is truncated instead. Each later term is at
    most 2^-8 of what it refines (2^-7 after the truncated first term,
    from 2^127 (2 - 2^-8) up)."""
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2 ** 32, 1_000_000, dtype=np.uint64)
    v = torch.from_numpy(bits.astype(np.uint32).view(np.float32))
    v = v[torch.isfinite(v) & (v.abs() >= 2.0 ** -110)]
    edges = torch.tensor([0.0, -0.0, F32_MAX, -F32_MAX, -3.4e38, 3.3961e38,
                          1.0, -1.0, 2.0 ** -110, 2.0 ** 127])
    v = torch.cat([v, edges])
    t = split_terms(v)
    assert all(torch.equal(a, a.to(BF16).float()) for a in t)
    assert torch.isfinite(t[0]).all()
    assert torch.equal(_exact_sum(t), v.double())
    truncated = v.abs() >= 2.0 ** 127 * (2 - 2.0 ** -8)
    assert torch.all(t[1].abs() <= torch.where(truncated, 2.0 ** -7,
                                               2.0 ** -8) * v.abs())
    assert torch.all(t[2].abs() <= 2.0 ** -8 * t[1].abs())


def test_split_below_2_pow_minus_110_loses_at_most_the_subnormal_floor():
    """Below ~2^-110 the third term falls under bf16's subnormal floor
    (2^-133): the sum then misses by at most 2^-133."""
    rng = np.random.default_rng(2)
    v = torch.from_numpy((rng.random(200_000) * 2.0 ** -110)
                         .astype(np.float32))
    miss = (_exact_sum(split_terms(v)) - v.double()).abs()
    assert miss.max().item() <= 2.0 ** -133
    assert (miss > 0).any()


def _bf16_excess(out, ref, abs_sum):
    """max(|out - ref| - the larger bf16 quantum of the two, 0) in f32
    unit roundoffs (2^-24) of ``abs_sum`` = sum |x||c|, per element."""
    out, ref = out.float(), ref.float()
    q = torch.maximum(*(torch.where(t == 0, torch.zeros_like(t), torch.ldexp(
        torch.ones_like(t), torch.frexp(t)[1] - 8)) for t in (out, ref)))
    over = ((out - ref).abs() - q).clamp_min(0)
    return torch.where(over == 0, torch.zeros_like(over),
                       over / (2.0 ** -24 * abs_sum))


def _check_emulation(x, idx, cb):
    """The emulated kernel against the reference's oracle within the bar
    of x's dtype; returns the emulated output."""
    out, ref = wgmma_emulation(x, idx, cb), codebook_matmul_ref(x, idx, cb)
    assert out.dtype == x.dtype
    if x.dtype == F32:
        torch.testing.assert_close(out, ref, rtol=1e-4,
                                   atol=1e-4 * x.shape[1] ** 0.5)
    else:
        abs_sum = x.float().abs() @ decode(idx, cb).abs()
        assert _bf16_excess(out, ref, abs_sum).max().item() <= SUM_ROUNDOFFS
    return out


def _kmeans_case(m, k, n, codes, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    cb = kmeans_codebook(w, codes)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    return x, narrow_indices(assign_codebook(w, cb), codes), cb


@pytest.mark.parametrize("x_dtype", [F32, BF16])
@pytest.mark.parametrize("m,k,n,codes", [(64, 256, 96, 16), (33, 200, 70, 256),
                                         (1, 512, 48, 16)])
def test_emulation_matches_reference_on_kmeans_codebooks(m, k, n, codes,
                                                         x_dtype):
    """Seeded weights clustered by the port's kmeans_codebook /
    assign_codebook at the embedded tier's k = 16 and at k = 256, x
    seeded in f32 or bf16: the kernel's arithmetic stays within the bar
    of x's dtype."""
    x, idx, cb = _kmeans_case(m, k, n, codes, seed=3)
    _check_emulation(x.to(x_dtype), idx, cb)


@pytest.mark.parametrize("x_dtype", [F32, BF16])
def test_emulation_with_huge_and_tiny_codewords(x_dtype):
    """Codewords near 2^100 with the largest f32 among them, and near
    2^-120 (the third term's lost bits): finite outputs; huge ones within
    16 f32 roundoffs of sum |x||c| (a sum can cancel far below terms that
    span 2^28, so rtol is no bar there), tiny ones within the bar of x's
    dtype (f32) or one quantum plus 2^-126 x sum |x| (bf16)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((48, 256)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 16, (256, 64)).astype(np.int8))
    base = np.sort(rng.standard_normal(16)).astype(np.float32)
    huge = torch.from_numpy(base * np.float32(2.0 ** 100))
    huge[-1] = F32_MAX
    xh = (x * 2.0 ** -40).to(x_dtype)
    out, ref = wgmma_emulation(xh, idx, huge), codebook_matmul_ref(xh, idx,
                                                                   huge)
    assert torch.isfinite(out.float()).all()
    abs_sum = xh.float().abs() @ decode(idx, huge).abs()
    gap = (_bf16_excess(out, ref, abs_sum) if x_dtype == BF16 else
           (out - ref).abs() / (2.0 ** -24 * abs_sum))
    assert gap.max().item() <= SUM_ROUNDOFFS
    tiny = torch.from_numpy(base * np.float32(2.0 ** -120))
    xt = x.to(x_dtype)
    out = wgmma_emulation(xt, idx, tiny)
    assert torch.isfinite(out.float()).all()
    if x_dtype == F32:
        _check_emulation(xt, idx, tiny)
    else:
        ref = codebook_matmul_ref(xt, idx, tiny).float()
        quantum = torch.ldexp(torch.ones_like(ref), torch.frexp(ref)[1] - 8)
        floor = 2.0 ** -126 * xt.float().abs().sum(1, keepdim=True)
        assert torch.all((out.float() - ref).abs() <= quantum + floor)


def test_f32_x_needs_its_six_products():
    """f32 x split as the codewords are: the six products x_a c_b with
    a + b < 3 keep the f32 bar; the three that x1 alone takes (x rounded
    once to bf16, x1 c1 + x1 c2 + x1 c3, summed in f32) do not."""
    x, idx, cb = _kmeans_case(64, 512, 96, 16, seed=5)
    ref = codebook_matmul_ref(x, idx, cb)
    six = _check_emulation(x, idx, cb)
    three = wgmma_emulation(x.to(BF16).float(), idx, cb)
    tol = 1e-4 * 512 ** 0.5
    assert torch.allclose(six, ref, rtol=1e-4, atol=tol)
    assert not torch.allclose(three, ref, rtol=1e-4, atol=tol)
