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
from repro_torch.kernels.codebook_matmul.ref import (codebook_matmul_ref,
                                                     decode)
from repro_torch.kernels.fake_quant import fake_quant
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.grad_aggregate import grad_aggregate
from repro_torch.kernels.grad_aggregate.ref import grad_aggregate_ref
from repro_torch.kernels.masked_matmul.ops import masked_product
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


def _bf16_qkv(c, device, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device, torch.bfloat16)
            for shape in ((c["b"], c["t"], c["h"], c["hd"]),
                          (c["b"], c["s"], c["hkv"], c["hd"]),
                          (c["b"], c["s"], c["hkv"], c["hd"]))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_cuda_bf16_routes(case, cuda_device):
    """bf16 on every case: hd 64 and 128 on the tensor-core kernel, hd
    32 on the CUDA-core kernel, each within one bf16 quantum of the plain
    version's f32 result plus 2e-5; rows that see no key exactly 0."""
    c = dict(FLASH_CASES[case])
    want = "wgmma" if c["hd"] in (64, 128) else "simt"
    q, k, v = _bf16_qkv(c, cuda_device, seed=9)
    kw = {n: c[n] for n in ("causal", "window", "q_offset") if n in c}
    before = dict(flash_attention.route_launches)
    out = flash_attention(q, k, v, **kw).float()
    after = flash_attention.route_launches
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == want) for r in after}
    ref = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    _, e = torch.frexp(ref)
    quantum = torch.ldexp(torch.ones_like(ref), e - 8)
    assert torch.all((out - ref).abs() <= quantum + 2e-5)
    if case == "masked_rows":                 # rows t < 10 see no key
        assert torch.equal(out[:, :10], torch.zeros_like(out[:, :10]))


@pytest.mark.cuda
def test_flash_attention_cuda_bf16_backward_is_plain_vjp(cuda_device):
    """The wgmma route's backward is the plain version's VJP, bitwise."""
    c = dict(b=1, t=70, s=70, h=4, hkv=2, hd=64)
    q, k, v = _bf16_qkv(c, cuda_device, seed=10)
    g = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (1, 70, 4, 64)).astype(np.float32)).to(cuda_device, torch.bfloat16)
    before = flash_attention.route_launches["wgmma"]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    grads = torch.autograd.grad(flash_attention(*leaves, window=9), leaves, g)
    assert flash_attention.route_launches["wgmma"] == before + 1
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*leaves, window=9),
                               leaves, g)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


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


SUM_ROUNDOFFS = 16      # f32 roundoffs of sum |a||b| allowed between orders


def _bf16_excess(out, ref, abs_sum):
    """max(|out - ref| - the larger bf16 quantum of the two, 0) in f32
    unit roundoffs (2^-24) of ``abs_sum`` = sum |a||b|, per element. Both
    round an f32 sum of the same bf16 products (exact in f32) taken in
    other orders: the sums differ by a few roundoffs of sum |a||b|, and
    rounding each to bf16 adds at most half a quantum of each."""
    out, ref = out.float(), ref.float()
    q = torch.maximum(*(torch.where(t == 0, torch.zeros_like(t), torch.ldexp(
        torch.ones_like(t), torch.frexp(t)[1] - 8)) for t in (out, ref)))
    over = ((out - ref).abs() - q).clamp_min(0)
    return torch.where(over == 0, torch.zeros_like(over),
                       over / (2.0 ** -24 * abs_sum))


def _check_bf16_grads(got, want, x, w, mask, g):
    """y, dx and dw against the plain version's autograd: within one
    quantum plus SUM_ROUNDOFFS roundoffs of sum |a||b|."""
    ax, ag = x.float().abs(), g.float().abs()
    awm = (w * mask).float().abs()
    for a, b, s in zip(got, want, (ax @ awm, ag @ awm.t(),
                                   (ax.t() @ ag) * mask.float())):
        assert a.dtype == torch.bfloat16
        assert _bf16_excess(a, b, s).max().item() <= SUM_ROUNDOFFS


@pytest.mark.cuda
@pytest.mark.parametrize("shape,route", [((136, 264, 200), "wgmma"),
                                         ((72, 1024, 80), "wgmma"),
                                         ((130, 257, 129), "simt")])
def test_masked_matmul_cuda_bf16_routes(shape, route, cuda_device):
    """Ragged bf16 shapes. TMA describes (136, 264, 200) and (72, 1024,
    80) (the latter's forward splits K in 4), so the forward and both
    gradients take the wgmma kernel; (130, 257, 129) has rows of 257 and
    129 elements, which TMA refuses, so all three take the CUDA-core
    kernel. Within one quantum plus 16 f32 roundoffs of sum |a||b| of the
    plain version; dw exactly 0 where the mask is 0."""
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = shape
    x, w, mask, g = _mm_inputs(m, k, n, torch.bfloat16, cuda_device)
    before = dict(masked_matmul.route_launches)
    got = _grads(masked_matmul, x, w, mask, g)
    after = masked_matmul.route_launches
    assert {r: after[r] - before[r] for r in after} == {
        r: 3 if r == route else 0 for r in after}
    _check_bf16_grads(got, _grads(masked_matmul_ref, x, w, mask, g),
                      x, w, mask, g)
    assert torch.all(got[2][mask == 0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,route", [((256, 3072, 512), "wgmma"),
                                         ((130, 257, 129), "simt")])
def test_masked_matmul_cuda_bf16_non_binary_mask(shape, route, cuda_device):
    """A mask that is 0 or uniform in [0, 1): w * mask is rounded to bf16
    before the product, as in the reference, so y and dx are within one
    quantum plus 16 f32 roundoffs of sum |a||b| of the plain version. dw
    is the reference's round(round(x^T @ g) * mask): bitwise the kernel's
    own unmasked x^T @ g multiplied by the mask in bf16, and that product
    within the same bound of the plain version's; exactly 0 where the
    mask is 0."""
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = shape
    x, w, _, g = _mm_inputs(m, k, n, torch.bfloat16, cuda_device)
    rng = np.random.default_rng(8)
    mask = torch.from_numpy(np.where(rng.random((k, n)) < 0.5, 0.0,
                                     rng.random((k, n))).astype(np.float32)
                            ).to(cuda_device, torch.bfloat16)
    before = masked_matmul.route_launches[route]
    got = _grads(masked_matmul, x, w, mask, g)
    assert masked_matmul.route_launches[route] == before + 3
    want = _grads(masked_matmul_ref, x, w, mask, g)
    ax, ag = x.float().abs(), g.float().abs()
    awm = (w * mask).float().abs()
    for a, b, s in zip(got[:2], want[:2], (ax @ awm, ag @ awm.t())):
        assert _bf16_excess(a, b, s).max().item() <= SUM_ROUNDOFFS
    xtg = masked_product(x.t(), g)
    assert torch.equal(got[2], xtg * mask)
    plain_xtg = (x.float().t() @ g.float()).to(torch.bfloat16)
    assert _bf16_excess(xtg, plain_xtg, ax.t() @ ag).max().item() \
        <= SUM_ROUNDOFFS
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



def _cb_inputs(m, k, n, x_dtype, device, codes=16, seed=9, cb_scale=1.0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, codes, (k, n)).astype(
        np.int8 if codes <= 128 else np.int32))
    cb = torch.from_numpy((np.sort(rng.standard_normal(codes)) * cb_scale)
                          .astype(np.float32))
    return x.to(device, x_dtype), idx.to(device), cb.to(device)


def _cb_check(out, x, idx, cb):
    """f32: rtol 1e-4, atol 1e-4 x sqrt(K) of the plain version; bf16:
    one quantum plus SUM_ROUNDOFFS f32 roundoffs of sum |x||c|."""
    ref = codebook_matmul_ref(x, idx, cb)
    assert out.dtype == x.dtype and out.shape == ref.shape
    if x.dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4,
                                   atol=1e-4 * x.shape[1] ** 0.5)
    else:
        abs_sum = x.float().abs() @ decode(idx, cb).abs()
        assert _bf16_excess(out, ref, abs_sum).max().item() <= SUM_ROUNDOFFS


def _cb_route_launch(x, idx, cb, route):
    """codebook_matmul(x, idx, cb), checked to launch once on ``route``."""
    before = dict(codebook_matmul.route_launches)
    out = codebook_matmul(x, idx, cb)
    after = codebook_matmul.route_launches
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route) for r in after}
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,codes", [((64, 128, 64), 16),
                                         ((130, 256, 144), 16),
                                         ((1, 128, 64), 16),
                                         ((130, 256, 144), 256),
                                         ((72, 1024, 80), 16),
                                         ((96, 200, 112), 16)])
def test_codebook_matmul_cuda_wgmma(shape, codes, x_dtype, cuda_device):
    """The tensor-core route for f32 and bf16 x, int8 (k = 16) and int32
    (k = 256) indices, ragged M and N, one row, (72, 1024, 80), whose K
    the plan splits in 4, and K = 200, not a multiple of the 64-deep
    step: within the bar of its dtype (f32: rtol 1e-4, atol 1e-4 x
    sqrt(K); bf16: one quantum plus 16 f32 roundoffs of sum |x||c|), one
    launch, on the wgmma kernel."""
    x, idx, cb = _cb_inputs(*shape, x_dtype, cuda_device, codes)
    _cb_check(_cb_route_launch(x, idx, cb, "wgmma"), x, idx, cb)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["x_col_major", "idx_col_major",
                                    "int64", "x_misaligned"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_codebook_matmul_cuda_layouts(layout, x_dtype, cuda_device):
    """Transposed views read in place (x column-major; int8 idx
    column-major, which the wgmma route narrows to row-major bytes first),
    int64 indices narrowed by the wrapper, and an x whose base is 4 bytes
    off 16, which TMA refuses: the CUDA-core route."""
    x, idx, cb = _cb_inputs(136, 192, 160, x_dtype, cuda_device)
    want = "wgmma"
    if layout == "x_col_major":
        x = x.t().contiguous().t()
    elif layout == "idx_col_major":
        idx = idx.t().contiguous().t()
    elif layout == "int64":
        idx = idx.long()
    else:
        buf = torch.zeros(x.numel() + 8, dtype=x_dtype, device=cuda_device)
        off = 4 // x.element_size()
        x = buf[off:off + x.numel()].view(x.shape).copy_(x)
        want = "simt"
    _cb_check(_cb_route_launch(x, idx, cb, want), x, idx, cb)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [2.0 ** -120, 2.0 ** 100],
                         ids=["tiny", "huge"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_codebook_matmul_cuda_wgmma_tiny_and_huge_codewords(scale, x_dtype,
                                                            cuda_device):
    """Codewords near 2^100, with the largest f32 among them (its first
    bf16 term must not round up to inf): the products span 2^28, so a
    sum can cancel far below its terms and the per-element rtol says
    nothing; both dtypes are held to the bf16 rule's sum term, 16 f32
    roundoffs of sum |x||c| (plus one quantum for bf16). Codewords near
    2^-120, where the third term loses the bits below bf16's subnormal
    floor (2^-133) and products fall below f32's normal range: f32 x
    within the f32 bar (its atol), bf16 x within one bf16 quantum plus
    2^-126 x sum |x| of the plain version. All on the wgmma route, all
    finite."""
    x, idx, cb = _cb_inputs(64, 256, 128, x_dtype, cuda_device,
                            cb_scale=scale)
    if scale > 1:
        x = (x.float() * 2.0 ** -40).to(x_dtype)
        cb[-1] = torch.finfo(torch.float32).max
    out = _cb_route_launch(x, idx, cb, "wgmma")
    assert torch.isfinite(out.float()).all()
    ref = codebook_matmul_ref(x, idx, cb).float()
    if scale > 1:
        abs_sum = x.float().abs() @ decode(idx, cb).abs()
        gap = (out.float() - ref).abs() / (2.0 ** -24 * abs_sum)
        if x_dtype == torch.bfloat16:
            gap = _bf16_excess(out, ref, abs_sum)
        assert gap.max().item() <= SUM_ROUNDOFFS
    elif x_dtype == torch.float32:
        _cb_check(out, x, idx, cb)
    else:
        quantum = torch.ldexp(torch.ones_like(ref), torch.frexp(ref)[1] - 8)
        floor = 2.0 ** -126 * x.float().abs().sum(1, keepdim=True)
        assert torch.all((out.float() - ref).abs() <= quantum + floor)


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int8, torch.int32])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_codebook_matmul_cuda_wgmma_out_of_range_follows_oracle(
        idx_dtype, x_dtype, cuda_device):
    """The oracle's index rules on the wgmma route, for int8 read in
    place and int32 narrowed first: -1 reads the last codeword, past the
    end the last, far below zero the first."""
    cb = torch.arange(16, dtype=torch.float32, device=cuda_device) + 1.0
    idx = torch.full((8, 16), 3, dtype=idx_dtype, device=cuda_device)
    idx[0, :5] = torch.tensor([-1, 16, 20, -20, 3])
    if idx_dtype == torch.int32:
        idx[1, :2] = torch.tensor([1 << 30, -(1 << 30)])
    x = torch.zeros((16, 8), dtype=x_dtype, device=cuda_device)
    x[0, 0] = x[1, 1] = 1.0
    out = _cb_route_launch(x, idx, cb, "wgmma")
    assert out[0, :5].tolist() == [16.0, 16.0, 16.0, 1.0, 4.0]
    if idx_dtype == torch.int32:
        assert out[1, :2].tolist() == [16.0, 1.0]
    assert torch.equal(out, codebook_matmul_ref(x, idx, cb))


@pytest.mark.cuda
def test_codebook_matmul_cuda_route_launches(cuda_device):
    """One launch a call, counted on the route that ``route`` names:
    wgmma for aligned f32 and bf16 x, simt for rows TMA refuses."""
    from repro_torch.kernels.codebook_matmul.ops import route
    for shape, want in (((64, 128, 64), "wgmma"), ((64, 129, 64), "simt")):
        for x_dtype in (torch.float32, torch.bfloat16):
            x, idx, cb = _cb_inputs(*shape, x_dtype, cuda_device)
            assert route(x, idx) == want
            launches = codebook_matmul.launches
            _cb_check(_cb_route_launch(x, idx, cb, want), x, idx, cb)
            assert codebook_matmul.launches == launches + 1


@pytest.mark.cuda
def test_codebook_matmul_cuda_wgmma_pads_f32_planes(cuda_device):
    """f32 x with K = 204: TMA reads its 816-byte rows, and the wrapper
    pads its bf16 planes' rows to 208 elements (TMA needs 16-byte rows),
    which the kernel never reads."""
    x, idx, cb = _cb_inputs(40, 204, 48, torch.float32, cuda_device)
    _cb_check(_cb_route_launch(x, idx, cb, "wgmma"), x, idx, cb)


# ------------------------------------------------------- fleet_aggregate

def _fleet_leaves(case: str, device, seed: int = 7):
    """(leaves, wn, wd) of one round's grouped call: the paper MLP's
    leaves over the bench tiers masked (full masks on matrices, scalar
    on biases, a tier of count 0) or width-sliced, the six-tier
    quickstart fleet masked, or ragged large leaves with sliced tiers."""
    from repro_torch.configs.paper_mlp import config
    from repro_torch.core.compression import DEVICE_TIERS, submodel_spec
    from repro_torch.models import mlp
    rng = np.random.default_rng(seed)
    if case == "ragged_large":
        params = {"a": torch.zeros(517, 2051), "b": torch.zeros(512, 2048),
                  "c": torch.zeros(2051)}
        locals_ = {"a": [(517, 2051), (517, 2051), (259, 1026), (130, 513)],
                   "b": [(512, 2048), (512, 2048), (256, 1026), (128, 512)],
                   "c": [(2051,), (2051,), (1026,), (513,)]}
        counts = [3.0, 0.0, 5.0, 1.0]
    else:
        params = mlp.init(torch.Generator().manual_seed(0), config(), "cpu")
        tiers = (("hub", "high", "mid", "mid", "low", "embedded")
                 if case == "six_tier" else ("hub", "high", "mid", "low"))
        counts = [3.0, 0.0, 5.0, 1.0, 2.0, 4.0][:len(tiers)]
        specs = [submodel_spec(params, DEVICE_TIERS[t].as_width_sliced().width)
                 if case == "paper_width" else None for t in tiers]
        locals_ = {k: [tuple(p.shape) if s is None else s.local_shape(i)
                       for s in specs]
                   for i, (k, p) in enumerate(params.items())}
    T = len(counts)
    wn = [f32(1.0 + 0.25 * t) for t in range(T)]
    wd = [f32(a * f32(c)) for a, c in zip(wn, counts)]
    leaves = {}
    for k, p in params.items():
        tiers_ = []
        for t, loc in enumerate(locals_[k]):
            g = torch.from_numpy(rng.standard_normal(loc).astype(np.float32))
            m = (torch.from_numpy((rng.random(loc) < 0.6).astype(np.float32))
                 if p.dim() >= 2 or t == 3 else torch.ones(()))
            tiers_.append((g.to(device), m.to(device)))
        leaves[k] = (tuple(p.shape), tiers_)
    return leaves, wn, wd


def _fleet_plain(leaves, wn, wd):
    from repro_torch.kernels.fleet_aggregate.ref import aggregate_leaf_ref
    return {k: aggregate_leaf_ref(s, tiers, wn, wd)
            for k, (s, tiers) in leaves.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["paper_masked", "paper_width", "six_tier",
                                  "ragged_large"])
def test_fleet_aggregate_cuda_bitwise_plain_version(case, cuda_device):
    """Tolerance: none. Every leaf of the group in one launch, bitwise the
    plain version on the card and on the CPU."""
    from repro_torch.kernels.fleet_aggregate import fleet_aggregate
    leaves, wn, wd = _fleet_leaves(case, cuda_device)
    before = fleet_aggregate.launches
    out = fleet_aggregate(leaves, wn, wd)
    assert fleet_aggregate.launches == before + 1
    plain = _fleet_plain(leaves, wn, wd)
    cpu = {k: (s, [(g.cpu(), m.cpu()) for g, m in tiers])
           for k, (s, tiers) in leaves.items()}
    plain_cpu = fleet_aggregate(cpu, wn, wd)
    for k in leaves:
        assert torch.equal(out[k], plain[k]), k
        assert torch.equal(out[k].cpu(), plain_cpu[k]), k


@pytest.mark.cuda
def test_fleet_aggregate_cuda_graph_replay(cuda_device):
    """The grouped launch captured in a CUDA graph and replayed: bitwise
    the eager call, also after the inputs change in place (the launch
    reads them where they lie)."""
    from repro_torch.kernels.fleet_aggregate import fleet_aggregate
    leaves, wn, wd = _fleet_leaves("paper_width", cuda_device)
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
    for k in leaves:
        assert torch.equal(out[k], eager[k]), k
    for _, tiers in leaves.values():
        for g, _ in tiers:
            g.mul_(-3.0)
    graph.replay()
    want = fleet_aggregate(leaves, wn, wd)
    torch.cuda.synchronize()
    for k in leaves:
        assert torch.equal(out[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("c_t", [8, 6, 5, 7])
@pytest.mark.parametrize("offset", [0, 1])
def test_fleet_aggregate_cuda_quads_and_tail(c_t, offset, cuda_device):
    """A leaf of 12 columns runs quads of columns: tiers whose c_t is a
    multiple of 4 and whose base is 16-byte aligned (offset 0) load 16
    bytes, the others element by element up to c_t (the scalar tail).
    Bitwise the plain version either way; a leaf of 13 columns runs one
    element per thread."""
    from repro_torch.kernels.fleet_aggregate import fleet_aggregate
    rng = np.random.default_rng(c_t + 10 * offset)
    leaves = {}
    for C in (12, 13):
        tiers = []
        for r, c in ((9, C), (9, C), (5, c_t), (3, c_t - 4)):
            buf = torch.from_numpy(
                rng.standard_normal(r * c + offset).astype(np.float32))
            g = buf.to(cuda_device)[offset:].view(r, c)
            m = torch.from_numpy((rng.random((r, c)) < 0.6)
                                 .astype(np.float32)).to(cuda_device)
            tiers.append((g, m))
        leaves[C] = ((9, C), tiers)
    wn, wd = [1.0, 0.5, 2.0, 1.0], [3.0, 0.0, 10.0, 1.0]
    out = fleet_aggregate(leaves, wn, wd)
    plain = _fleet_plain(leaves, wn, wd)
    for C in leaves:
        assert torch.equal(out[C], plain[C]), C


@pytest.mark.cuda
def test_fleet_aggregate_cuda_chunks_by_max_leaves(cuda_device):
    """37 leaves: three launches into one slab, bitwise the plain
    version."""
    from repro_torch.kernels.fleet_aggregate import fleet_aggregate
    from repro_torch.kernels.fleet_aggregate.ops import MAX_LEAVES
    base, wn, wd = _fleet_leaves("paper_masked", cuda_device)
    leaves = {(c, k): v for c in range(4) for k, v in base.items()}
    leaves = dict(list(leaves.items())[:37])
    before = fleet_aggregate.launches
    out = fleet_aggregate(leaves, wn, wd)
    assert fleet_aggregate.launches == before + -(-37 // MAX_LEAVES)
    plain = _fleet_plain(leaves, wn, wd)
    for k in leaves:
        assert torch.equal(out[k], plain[k]), k
