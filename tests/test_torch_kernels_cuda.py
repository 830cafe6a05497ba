"""The port's CUDA kernels against their plain PyTorch versions on the
card. These tests need a CUDA device (a CUDA kernel has no CPU mode) and
skip without one; they import no JAX, so they run on a GPU machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.aggregation import f32
from repro_torch.kernels import codebook_matmul, masked_matmul
from repro_torch.kernels.codebook_matmul.ref import codebook_matmul_ref
from repro_torch.kernels.fake_quant import fake_quant
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.grad_aggregate import grad_aggregate
from repro_torch.kernels.grad_aggregate.ref import grad_aggregate_ref
from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref
from repro_torch.kernels.structured_scatter import structured_scatter_batched
from repro_torch.kernels.structured_scatter.ops import structured_scatter
from repro_torch.numerics import FORMATS, quantize_em

W = [1.0, 0.5, 2.0, 1.0]
N_PART = [3.0, 0.0, 5.0, 1.0]
# leaf shape -> per-tier local shapes and which tiers carry scalar masks
SCATTER_CASES = {
    "1d": ((10,), [(10,), (10,), (5,), (3,)], [True, True, True, True]),
    "2d": ((10, 10), [(10, 10), (10, 10), (5, 5), (3, 3)],
           [False, False, False, False]),
    "2d_edge": ((5, 10), [(5, 10), (5, 10), (5, 5), (5, 3)],
                [False, True, False, True]),
    "3d": ((4, 3, 6), [(4, 3, 6), (4, 3, 6), (2, 3, 3), (1, 3, 2)],
           [False, False, True, False]),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scalar_masks", [False, True])
def test_grad_aggregate_cuda_bitwise_plain_version(scalar_masks, cuda_device):
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal((4, 1001)).astype(np.float32))
    m = (torch.tensor([[1.0], [0.0], [1.0], [1.0]]) if scalar_masks else
         torch.from_numpy((rng.random((4, 1001)) < 0.6).astype(np.float32)))
    wd = [f32(w * n) for w, n in zip(W, N_PART)]
    before = grad_aggregate.launches
    out = grad_aggregate(g.to(cuda_device), m.to(cuda_device), W, w_den=wd)
    assert grad_aggregate.launches == before + 1
    ref = grad_aggregate_ref(g.to(cuda_device), m.to(cuda_device),
                             [f32(w) for w in W], wd)
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_structured_scatter_cuda_bitwise_plain_version(case, cuda_device):
    shape, locals_, scalar = SCATTER_CASES[case]
    rng = np.random.default_rng(1)
    gs = [torch.from_numpy(rng.standard_normal((3,) + s).astype(np.float32))
          for s in locals_]
    ms = [torch.ones(3) if sc else
          torch.from_numpy((rng.random((3,) + s) < 0.7).astype(np.float32))
          for s, sc in zip(locals_, scalar)]
    wd = [w * n for w, n in zip(W, N_PART)]
    before = structured_scatter.launches
    out = structured_scatter_batched([g.to(cuda_device) for g in gs],
                                     [m.to(cuda_device) for m in ms], W, wd,
                                     out_shape=shape)
    assert structured_scatter.launches == before + 1
    ref = structured_scatter_batched(gs, ms, W, wd, out_shape=shape)
    assert torch.equal(out.cpu(), ref)


def _fq_values(n: int = 200_003) -> np.ndarray:
    """Normals over 160 binades, f32 subnormals, specials and values past
    every format's saturation."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(n) * np.exp(rng.uniform(-80.0, 80.0, n))
    sub = rng.standard_normal(1000) * 1e-40
    specials = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 3e38,
                -3e38, 480.0, 481.0, 57344.0, 65504.0, 65520.0]
    return np.concatenate([x, sub, specials]).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", sorted(f for f, v in FORMATS.items()
                                       if v.e_bits > 0))
def test_fake_quant_cuda_bitwise_plain_version(fmt, cuda_device):
    """Tolerance: none (bit patterns equal, NaN == NaN), subnormals and
    specials included; also equal to the plain version on the CPU."""
    f = FORMATS[fmt]
    x = torch.from_numpy(_fq_values())
    xd = x.to(cuda_device)
    before = fake_quant.launches
    out = fake_quant(xd, f.e_bits, f.m_bits)
    assert fake_quant.launches == before + 1
    for ref in (quantize_em(xd, f.e_bits, f.m_bits).cpu(),
                quantize_em(x, f.e_bits, f.m_bits)):
        a = out.cpu().numpy().view(np.uint32)
        b = ref.numpy().view(np.uint32)
        nan = np.isnan(out.cpu().numpy()) & np.isnan(ref.numpy())
        assert np.all((a == b) | nan), fmt


@pytest.mark.cuda
def test_fake_quant_cuda_non_contiguous_input(cuda_device):
    x = torch.from_numpy(_fq_values(4096)[:4096].reshape(64, 64))
    xt = x.to(cuda_device).t()
    out = fake_quant(xt, 4, 3)
    assert torch.equal(out.cpu(), quantize_em(x.t(), 4, 3))


FLASH_CASES = {
    "causal_gqa3_hd128": dict(b=2, t=200, s=200, h=6, hkv=2, hd=128),
    "noncausal_ragged_hd64": dict(b=1, t=77, s=131, h=4, hkv=4, hd=64,
                                  causal=False),
    "window_gqa2_hd32": dict(b=2, t=160, s=160, h=4, hkv=2, hd=32, window=17),
    "q_offset_hd128": dict(b=1, t=40, s=300, h=3, hkv=1, hd=128, q_offset=260),
    "masked_rows": dict(b=1, t=64, s=64, h=2, hkv=1, hd=64, q_offset=-10),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_cuda_matches_plain_version(case, cuda_device):
    """f32: atol/rtol 2e-5 (another summation order than the plain
    version's matmuls, TF32 off); fully masked rows exactly 0."""
    torch.backends.cuda.matmul.allow_tf32 = False
    c = dict(FLASH_CASES[case])
    b, t, s, h, hkv, hd = (c.pop(k) for k in ("b", "t", "s", "h", "hkv", "hd"))
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(cuda_device) for shape in ((b, t, h, hd), (b, s, hkv, hd),
                                              (b, s, hkv, hd)))
    before = flash_attention.launches
    out = flash_attention(q, k, v, **c)
    assert flash_attention.launches == before + 1
    ref = flash_attention_ref(q, k, v, **c)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    if case == "masked_rows":                 # rows t < 10 see no key
        assert torch.equal(out[:, :10], torch.zeros_like(out[:, :10]))


@pytest.mark.cuda
def test_flash_attention_cuda_bf16_within_one_quantum(cuda_device):
    """bf16 in and out, against the plain version's f32-accumulated
    result on the same bf16 inputs."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(cuda_device, torch.bfloat16)
               for shape in ((2, 130, 6, 128), (2, 130, 2, 128),
                             (2, 130, 2, 128)))
    out = flash_attention(q, k, v).float()
    ref = flash_attention_ref(q.float(), k.float(), v.float())
    _, e = torch.frexp(ref)
    quantum = torch.ldexp(torch.ones_like(ref), e - 8)   # bf16 ulp of ref
    # one bf16 quantum of the f32 result, plus the f32 kernel's 2e-5 for
    # its summation order (which a value near 0 does not scale down)
    assert torch.all((out - ref).abs() <= quantum + 2e-5)


@pytest.mark.cuda
def test_flash_attention_cuda_backward_is_plain_vjp(cuda_device):
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(cuda_device) for shape in ((1, 70, 4, 64), (1, 70, 2, 64),
                                              (1, 70, 2, 64)))
    g = torch.from_numpy(rng.standard_normal((1, 70, 4, 64))
                         .astype(np.float32)).to(cuda_device)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    grads = torch.autograd.grad(flash_attention(*leaves, window=9), leaves, g)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*leaves, window=9),
                               leaves, g)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


MATMUL_SHAPES = [(64, 200, 96), (1, 128, 128), (130, 257, 129),
                 (16, 10, 10), (300, 512, 384)]


def _mm_inputs(m, k, n, dtype, device, seed=6):
    rng = np.random.default_rng(seed)
    x, w, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(device, dtype) for s in ((m, k), (k, n), (m, n)))
    mask = torch.from_numpy((rng.random((k, n)) < 0.25).astype(np.float32)
                            ).to(device, dtype)
    return x, w, mask, g


def _grads(fn, x, w, mask, g):
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = fn(xl, wl, mask)
    dx, dw = torch.autograd.grad(y, (xl, wl), g)
    return y.detach(), dx, dw


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MATMUL_SHAPES)
def test_masked_matmul_cuda_matches_plain_version(shape, cuda_device):
    """f32, TF32 off: y, dx and dw within rtol 1e-4 and atol 1e-4 x
    sqrt(contraction length) of the plain version's autograd (the
    reference test's bound; another summation order); dw exactly 0 where
    the mask is 0; three launches (forward, dx, dw)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = shape
    x, w, mask, g = _mm_inputs(m, k, n, torch.float32, cuda_device)
    before = masked_matmul.launches
    got = _grads(masked_matmul, x, w, mask, g)
    assert masked_matmul.launches == before + 3
    want = _grads(masked_matmul_ref, x, w, mask, g)
    for a, b, depth in zip(got, want, (k, n, m)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * depth ** 0.5)
    assert torch.all(got[2][mask == 0] == 0)


@pytest.mark.cuda
def test_masked_matmul_cuda_bf16_within_one_quantum(cuda_device):
    """bf16 operands: y, dx and dw within one bf16 quantum of the plain
    version, which rounds an f32 product of the same bf16 inputs."""
    x, w, mask, g = _mm_inputs(130, 257, 129, torch.bfloat16, cuda_device)
    got = _grads(masked_matmul, x, w, mask, g)
    want = _grads(masked_matmul_ref, x, w, mask, g)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        a, b = a.float(), b.float()
        _, e = torch.frexp(b)
        quantum = torch.where(b == 0, torch.zeros_like(b),
                              torch.ldexp(torch.ones_like(b), e - 8))
        assert torch.all((a - b).abs() <= quantum)
    assert torch.all(got[2][mask == 0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype,codes", [(torch.int8, 16),
                                             (torch.int32, 16),
                                             (torch.int32, 256),
                                             (torch.int64, 16),
                                             (torch.int64, 200)])
@pytest.mark.parametrize("shape", [(64, 128, 64), (130, 257, 129),
                                   (1, 100, 60)])
def test_codebook_matmul_cuda_matches_plain_version(shape, idx_dtype, codes,
                                                    cuda_device):
    """f32: rtol 1e-4, atol 1e-4 x sqrt(K) of the plain version (another
    summation order, TF32 off); int64 indices are narrowed by the
    wrapper; one launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = shape
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, codes, (k, n))).to(idx_dtype)
    cb = torch.from_numpy(np.sort(rng.standard_normal(codes))
                          .astype(np.float32))
    xd, idd, cbd = x.to(cuda_device), idx.to(cuda_device), cb.to(cuda_device)
    before = codebook_matmul.launches
    out = codebook_matmul(xd, idd, cbd)
    assert codebook_matmul.launches == before + 1
    torch.testing.assert_close(out, codebook_matmul_ref(xd, idd, cbd),
                               rtol=1e-4, atol=1e-4 * k ** 0.5)
    torch.testing.assert_close(out.cpu(), codebook_matmul_ref(x, idx, cb),
                               rtol=1e-4, atol=1e-4 * k ** 0.5)


@pytest.mark.cuda
def test_codebook_matmul_cuda_out_of_range_follows_oracle(cuda_device):
    """Indices outside [0, n_codes) read what the plain version (the JAX
    oracle's gather) reads: -1 the last codeword, past the end the last,
    far below zero the first."""
    cb = torch.arange(16, dtype=torch.float32, device=cuda_device) + 1.0
    idx = torch.tensor([[-1, 16, 20, -20, 3]], dtype=torch.int32,
                       device=cuda_device)
    x = torch.ones((1, 1), device=cuda_device)
    out = codebook_matmul(x, idx, cb)
    assert out.tolist() == [[16.0, 16.0, 16.0, 1.0, 4.0]]
    assert torch.equal(out, codebook_matmul_ref(x, idx, cb))
