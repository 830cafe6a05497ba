"""Port parity for the LM path's two kernels, on the CPU: the plain
versions that the port's fake_quant and flash_attention wrappers take on
CPU tensors, against the reference's Pallas kernels run as its own tests
run them (interpret mode off the TPU), with numpy-seeded inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fake_quant import fake_quant as j_fake_quant
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.numerics import quantize_em as j_quantize_em
from repro_torch.core.compression.quantization import fake_quant_ste
from repro_torch.kernels.fake_quant import fake_quant
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.numerics import FORMATS

torch.set_num_threads(1)

EM_FORMATS = sorted(k for k, f in FORMATS.items() if f.e_bits > 0)


def _values(seed: int, n: int = 20_000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * np.exp(rng.uniform(-60.0, 60.0, n))
    return np.concatenate([x, [0.0, -0.0, np.nan, 1e30, -1e30, 481.0,
                               65520.0]]).astype(np.float32)


def _kernel_band(x: np.ndarray, e_bits: int, m_bits: int) -> np.ndarray:
    """Where the reference's TPU kernel is not its own oracle (see
    test_fake_quant_reference_kernel_band): for the e=8 formats, the
    quantum's FTZ band below 2**(-126+m) and |x| >= 2**127."""
    if e_bits != 8:
        return np.zeros(x.shape, bool)
    ax = np.abs(x)
    return (ax < np.float32(2.0 ** (-126 + m_bits))) | (ax >= np.float32(2.0 ** 127))


def _same_bits(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a) & np.isnan(b))


@pytest.mark.parametrize("fmt", EM_FORMATS)
def test_fake_quant_plain_version_bitwise_reference_kernel(fmt):
    """Tolerance: none (bit patterns equal, NaN == NaN), on finite values
    over 170 binades, ±0, NaN and values past saturation, outside the
    reference kernel's band; ±inf pass through as in the reference's
    oracle (``quantize_em``)."""
    f = FORMATS[fmt]
    x = _values(0)
    ref = np.asarray(j_fake_quant(jnp.asarray(x), f.e_bits, f.m_bits))
    out = fake_quant(torch.from_numpy(x), f.e_bits, f.m_bits).numpy()
    keep = ~_kernel_band(x, f.e_bits, f.m_bits)
    assert keep.sum() > 15_000
    assert _same_bits(ref[keep], out[keep]).all()
    inf = np.array([np.inf, -np.inf], np.float32)
    assert _same_bits(
        np.asarray(j_quantize_em(jnp.asarray(inf), f.e_bits, f.m_bits)),
        fake_quant(torch.from_numpy(inf), f.e_bits, f.m_bits).numpy()).all()


def test_fake_quant_reference_kernel_band():
    """Pins where the reference's Pallas kernel differs from the port
    (and from its own oracle): it saturates ±inf to ±maxv for e < 8 and
    maps +inf to -inf for e = 8; for e = 8 it returns 0 for |x| >= 2**127
    (its 2**-ex is built for exponents >= -126 only) and flushes f32
    subnormal inputs to 0. The port returns ±inf, the exact grid value,
    and the subnormal grid value."""
    x = np.array([np.inf, -np.inf, 3e38, 1e-40], np.float32)
    k = lambda e, m: np.asarray(j_fake_quant(jnp.asarray(x), e, m))
    p = lambda e, m: fake_quant(torch.from_numpy(x), e, m).numpy()
    assert list(k(4, 3)[:2]) == [480.0, -480.0]
    assert list(p(4, 3)[:2]) == [np.inf, -np.inf]
    assert k(8, 7)[0] == -np.inf and p(8, 7)[0] == np.inf
    assert k(8, 7)[2] == 0.0 and p(8, 7)[2] == np.float32(3.00405527e38)
    assert k(8, 23)[3] == 0.0 and p(8, 23)[3] == np.float32(1e-40)


def test_fake_quant_ste_gradient_bitwise_reference_kernel():
    """The clip-aware STE: identity inside ±maxv, zero outside — the
    gradient the reference's kernel wrapper gives, bit for bit."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4000) * 300).astype(np.float32)
    c = rng.standard_normal(4000).astype(np.float32)
    for fmt in EM_FORMATS:
        f = FORMATS[fmt]
        gj = np.asarray(jax.grad(lambda v: jnp.sum(
            j_fake_quant(v, f.e_bits, f.m_bits) * c))(jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_(True)
        (fake_quant_ste(xt, f.e_bits, f.m_bits)
         * torch.from_numpy(c)).sum().backward()
        assert np.array_equal(gj, xt.grad.numpy()), fmt


def test_fake_quant_takes_plain_version_on_cpu_only():
    x = torch.randn(10)
    before = fake_quant.launches
    fake_quant(x, 4, 3)
    assert fake_quant.launches == before       # no kernel on a CPU tensor
    with pytest.raises(ValueError, match="e_bits"):
        fake_quant(x, 0, 8)


def _qkv(seed, b, t, s, h, hkv, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, t, h, hd), (b, s, hkv, hd), (b, s, hkv, hd))]


FLASH_CASES = {
    # name: (b, t, s, h, hkv, hd, causal, window, q_offset)
    "causal_rep3": (2, 64, 64, 6, 2, 32, True, 0, 0),
    "noncausal_rep1_ragged_s": (1, 40, 150, 2, 2, 32, False, 0, 0),
    "window_rep2": (1, 96, 96, 4, 2, 16, True, 9, 0),
    "q_offset_rep2_ragged_s": (1, 24, 133, 4, 2, 32, True, 0, 109),
    "masked_rows": (1, 32, 32, 3, 1, 16, True, 0, -5),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_plain_version_matches_reference_kernel(case):
    """Forward and gradient against the reference's flash_attention (the
    Pallas kernel in interpret mode; its VJP is the oracle's) at rtol and
    atol 1e-5, f32. Rows that see no key (q_offset < 0) are exactly 0."""
    b, t, s, h, hkv, hd, causal, window, q_offset = FLASH_CASES[case]
    q, k, v = _qkv(7, b, t, s, h, hkv, hd)
    g = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ref = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **kw))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, **kw)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    if q_offset < 0:
        assert not out[:, :-q_offset].detach().any()
    jgrads = jax.grad(lambda q, k, v: jnp.sum(j_flash(q, k, v, **kw) * g),
                      argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tgrads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, bt in zip(jgrads, tgrads):
        np.testing.assert_allclose(bt.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
