"""Port parity: the (1, e, m) float simulation of repro_torch.numerics held
BITWISE against repro.numerics on the CPU, for every format, away from the
band where the reference's CPU backend flushes subnormals to zero."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.numerics import FORMATS as J_FORMATS
from repro.numerics import max_finite as j_max_finite
from repro.numerics import quantize_em as j_quantize_em
from repro_torch.numerics import FORMATS, max_finite, quantize_em, quantize_int

torch.set_num_threads(1)

SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -3e-39,
                     65504.0, 1e30, -1e30], np.float32)


def _values(seed: int, n: int = 50_000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * np.exp(rng.uniform(-80.0, 80.0, n))
    return np.concatenate([x.astype(np.float32), SPECIALS])


def _ftz_band(x: np.ndarray, e_bits: int, m_bits: int) -> np.ndarray:
    """Where the e=8 formats' quantum 2**(ex-m) is an f32 subnormal."""
    if e_bits != 8:
        return np.zeros(x.shape, bool)
    return np.abs(x) < np.float32(2.0 ** (-126 + m_bits))


def _same_bits(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a) & np.isnan(b))


def test_formats_table_matches_reference():
    assert {k: (f.e_bits, f.m_bits, f.bits) for k, f in FORMATS.items()} == \
        {k: (f.e_bits, f.m_bits, f.bits) for k, f in J_FORMATS.items()}
    for f in FORMATS.values():
        assert max_finite(f.e_bits, f.m_bits) == float(
            j_max_finite(f.e_bits, f.m_bits))


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_em_bitwise_outside_ftz_band(fmt, seed):
    """Tolerance: none (bit patterns equal, NaN == NaN), including ±0,
    ±inf and NaN; only the flush-to-zero band is excluded."""
    f = FORMATS[fmt]
    x = _values(seed)
    ref = np.asarray(j_quantize_em(jnp.asarray(x), f.e_bits, f.m_bits))
    out = quantize_em(torch.from_numpy(x), f.e_bits, f.m_bits).numpy()
    keep = ~_ftz_band(x, f.e_bits, f.m_bits)
    assert keep.sum() > 40_000
    assert _same_bits(ref[keep], out[keep]).all()


@pytest.mark.parametrize("fmt", ["bf16", "fp32"])
def test_quantize_em_ftz_band_is_reference_behaviour(fmt):
    """Below 2**(-126+m) the reference's quantum is a subnormal that the
    CPU backend flushes to 0, so it returns NaN there; the port returns
    the exact value on the subnormal grid 2**(emin-m)."""
    f = FORMATS[fmt]
    x = np.array([2.258e-38, -1.1e-37, 3.3e-39, 7.0e-41], np.float32)
    assert _ftz_band(x, f.e_bits, f.m_bits).all()
    ref = np.asarray(j_quantize_em(jnp.asarray(x), f.e_bits, f.m_bits))
    assert np.isnan(ref[0])
    out = quantize_em(torch.from_numpy(x), f.e_bits, f.m_bits).numpy()
    x64 = x.astype(np.float64)
    ex = np.maximum(np.frexp(np.abs(x64))[1] - 1, -126)
    q = 2.0 ** (ex - f.m_bits)                  # exact in float64
    exact = (np.round(x64 / q) * q).astype(np.float32)
    assert np.array_equal(out.view(np.uint32), exact.view(np.uint32))


def test_quantize_em_saturates_and_keeps_non_finite():
    x = torch.tensor([1e9, -1e9, float("inf"), float("nan")])
    out = quantize_em(x, 4, 3)
    assert out[0].item() == 480.0 and out[1].item() == -480.0
    assert out[2].item() == float("inf") and torch.isnan(out[3])


def test_quantize_int_symmetric_grid():
    x = torch.linspace(-3.0, 3.0, 101)
    q = quantize_int(x, 4)
    scale = 3.0 / 7.0
    assert torch.allclose(q / scale, torch.round(q / scale), atol=1e-5)
    assert q.abs().max().item() == pytest.approx(3.0)
