"""The port's matmul kernels (masked_matmul, codebook_matmul) against the
reference's public kernel API on the CPU. The port's wrappers take their
plain versions on CPU tensors; the reference runs its Pallas kernels in
interpret mode off the TPU. Inputs are made with numpy from a seed. The
CUDA kernels themselves are held against the plain versions in
test_torch_kernels_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import codebook_matmul as j_codebook_matmul
from repro.kernels import masked_matmul as j_masked_matmul
from repro.kernels.codebook_matmul.kernel import codebook_matmul_raw
from repro.kernels.codebook_matmul.ref import (
    codebook_matmul_ref as j_codebook_ref)
from repro.kernels.masked_matmul.ref import masked_matmul_ref as j_masked_ref
from repro_torch.core.compression import DEVICE_TIERS, magnitude_mask
from repro_torch.core.compression.clustering import (assign_codebook,
                                                     kmeans_codebook)
from repro_torch.kernels import codebook_matmul, masked_matmul
from repro_torch.kernels.codebook_matmul.ops import narrow_indices
from repro_torch.kernels.codebook_matmul.ref import codebook_matmul_ref

torch.set_num_threads(1)


def _mm_inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    mask = (rng.random((k, n)) < 0.5).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    return x, w, mask, g


@pytest.mark.parametrize("m,k,n", [(64, 200, 96), (1, 128, 128),
                                   (130, 257, 129)])
def test_masked_matmul_matches_reference(m, k, n):
    """y, dx and dw against the reference kernel's custom VJP and its
    oracle's autodiff: rtol 1e-4, atol 1e-4 x sqrt(contraction length),
    the reference test's bound (f32 sums in other orders); dw exactly 0
    where the mask is 0, in both packages."""
    x, w, mask, g = _mm_inputs(m, k, n)
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    y = masked_matmul(xt, wt, torch.from_numpy(mask))
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))
    for fn in (j_masked_matmul, j_masked_ref):
        jy, vjp = jax.vjp(lambda a, b: fn(a, b, jnp.asarray(mask)),
                          jnp.asarray(x), jnp.asarray(w))
        jdx, jdw = vjp(jnp.asarray(g))
        for ours, ref, depth in ((y, jy, k), (dx, jdx, n), (dw, jdw, m)):
            np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                                       rtol=1e-4, atol=1e-4 * depth ** 0.5)
        assert np.all(np.asarray(jdw)[mask == 0] == 0)
    assert torch.all(dw[torch.from_numpy(mask) == 0] == 0)


def test_masked_matmul_bf16_matches_reference_oracle():
    """bf16 x, w, mask: the product is taken in f32 and rounded to bf16
    in both packages, so the results differ by at most one bf16 quantum
    (the f32 sums round differently near a bf16 boundary)."""
    x, w, mask, _ = _mm_inputs(48, 96, 40, seed=1)
    xb, wb, mb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, mask))
    y = masked_matmul(xb, wb, mb)
    assert y.dtype == torch.bfloat16
    jy = j_masked_ref(*(jnp.asarray(a.float().numpy(), jnp.bfloat16)
                        for a in (xb, wb, mb)))
    ref = np.asarray(jy.astype(jnp.float32))
    _, e = np.frexp(ref)
    quantum = np.where(ref == 0, 0.0, np.ldexp(np.ones_like(ref), e - 8))
    assert np.all(np.abs(y.float().numpy() - ref) <= quantum)


@pytest.mark.parametrize("idx_dtype", [np.int8, np.int32])
def test_codebook_matmul_matches_reference(idx_dtype):
    """int8 and int32 indices against the reference kernel (interpret)
    and its oracle: rtol 1e-4, atol 1e-3 (the reference test's bound)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((40, 100)).astype(np.float32)
    idx = rng.integers(0, 16, (100, 60)).astype(idx_dtype)
    cb = np.sort(rng.standard_normal(16)).astype(np.float32)
    out = codebook_matmul(torch.from_numpy(x), torch.from_numpy(idx),
                          torch.from_numpy(cb)).numpy()
    for fn in (j_codebook_matmul, j_codebook_ref):
        np.testing.assert_allclose(
            out, np.asarray(fn(jnp.asarray(x), jnp.asarray(idx),
                               jnp.asarray(cb))), rtol=1e-4, atol=1e-3)


def test_codebook_matmul_reference_out_of_range_band():
    """The reference disagrees with itself outside [0, n_codes): its TPU
    kernel matches no codeword and gives 0.0; its oracle gathers like
    JAX, a negative index counting from the end and then clamped. The
    port follows the oracle on the CPU (and its CUDA kernel does the
    same)."""
    cb = np.arange(16, dtype=np.float32) + 1.0
    idx = np.array([[-1, 16, 20, -20, 3]], np.int32)
    x = np.ones((1, 1), np.float32)
    tpu = np.asarray(codebook_matmul_raw(
        jnp.asarray(np.pad(x, ((0, 7), (0, 127)))),
        jnp.asarray(np.pad(idx, ((0, 127), (0, 123)))),
        jnp.asarray(cb), block=(8, 128, 128), interpret=True))[:1, :5]
    oracle = np.asarray(j_codebook_ref(jnp.asarray(x), jnp.asarray(idx),
                                       jnp.asarray(cb)))
    port = codebook_matmul(torch.from_numpy(x), torch.from_numpy(idx),
                           torch.from_numpy(cb)).numpy()
    assert tpu.tolist() == [[0.0, 0.0, 0.0, 0.0, 4.0]]
    assert oracle.tolist() == [[16.0, 16.0, 16.0, 1.0, 4.0]]
    np.testing.assert_array_equal(port, oracle)


def test_codebook_matmul_on_assigned_codebook():
    """The chip smoke's producer chain at a small size: a pruned weight
    clustered by the port's kmeans_codebook / assign_codebook at the
    embedded tier's k, whose int64 indices the wrapper narrows to int8;
    the product equals x @ (the clustered weight) exactly as the plain
    version computes it."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((96, 64)).astype(np.float32))
    w = w * magnitude_mask(w, DEVICE_TIERS["low"].density)
    k = DEVICE_TIERS["embedded"].cluster_k
    cb = kmeans_codebook(w, k)
    idx = assign_codebook(w, cb)
    assert idx.dtype == torch.int64
    assert narrow_indices(idx, k).dtype == torch.int8
    assert narrow_indices(idx, 200).dtype == torch.int32
    x = torch.from_numpy(rng.standard_normal((8, 96)).astype(np.float32))
    assert torch.equal(codebook_matmul(x, idx, cb), x @ cb[idx])
    assert torch.equal(codebook_matmul_ref(x, narrow_indices(idx, k), cb),
                       x @ cb[idx])


def test_matmul_wrappers_refuse_mixed_devices_and_shapes():
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="one device"):
        masked_matmul(x, torch.zeros((3, 2), device="meta"),
                      torch.zeros((3, 2), device="meta"))
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        masked_matmul(x, torch.zeros((4, 2)), torch.zeros((4, 2)))
    with pytest.raises(ValueError, match="one device"):
        codebook_matmul(x, torch.zeros((3, 2), dtype=torch.int32,
                                       device="meta"), torch.zeros(4))
    with pytest.raises(TypeError, match="int8, int32 or int64"):
        narrow_indices(torch.zeros((3, 2), dtype=torch.int16), 16)
