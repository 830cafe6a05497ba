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
from repro_torch.kernels.codebook_matmul.ref import (codebook_matmul_ref,
                                                     decode, wgmma_emulation)
from repro_torch.kernels.masked_matmul.ops import (backend, route,
                                                   wgmma_plan)

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


def _bf16_within(out, ref, abs_sum, roundoffs=16):
    """|out - ref| <= the larger bf16 quantum + ``roundoffs`` f32 unit
    roundoffs (2^-24) of sum |a||b|: two f32 sums of the same bf16
    products in other orders, each rounded to bf16."""
    out, ref = (np.asarray(t, np.float32) for t in (out, ref))
    q = np.maximum(*(np.where(t == 0, 0.0, np.ldexp(1.0, np.frexp(t)[1] - 8))
                     for t in (out, ref)))
    return np.all(np.abs(out - ref) <= q + roundoffs * 2.0 ** -24 * abs_sum)


def test_masked_matmul_bf16_non_binary_mask_matches_reference():
    """bf16 with a mask that is 0 or uniform in [0, 1), against the
    reference kernel's custom VJP (Pallas in interpret mode). x and g are
    small integers, so x^T @ g is exact in f32 in any order; then the
    plain version's dw is round(round(x^T @ g) * mask), bitwise the
    reference's, and not the single rounding of (x^T @ g) * mask that a
    kernel multiplying its f32 sum by the mask would give. y and dx (sums
    of the bf16 products x * round(w * mask)) agree within one quantum
    plus 16 f32 roundoffs of sum |a||b|."""
    rng = np.random.default_rng(4)
    m, k, n = 48, 96, 40
    x = rng.integers(-8, 9, (m, k)).astype(np.float32)
    g = rng.integers(-8, 9, (m, n)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    mask = np.where(rng.random((k, n)) < 0.5, 0.0,
                    rng.random((k, n))).astype(np.float32)
    xb, wb, mb, gb = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (x, w, mask, g))
    xl, wl = xb.clone().requires_grad_(), wb.clone().requires_grad_()
    y = masked_matmul(xl, wl, mb)
    dx, dw = torch.autograd.grad(y, (xl, wl), gb)
    xtg = xb.float().t() @ gb.float()
    assert torch.equal(dw, xtg.to(torch.bfloat16) * mb)
    assert not torch.equal(dw, (xtg * mb.float()).to(torch.bfloat16))
    to_j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
    jy, vjp = jax.vjp(lambda a, b: j_masked_matmul(a, b, to_j(mb)),
                      to_j(xb), to_j(wb))
    jdx, jdw = vjp(to_j(gb))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    np.testing.assert_array_equal(dw.float().numpy(), f32(jdw))
    awm = (wb * mb).float().abs()
    assert _bf16_within(y.detach().float().numpy(), f32(jy),
                        (xb.float().abs() @ awm).numpy())
    assert _bf16_within(dx.float().numpy(), f32(jdx),
                        (gb.float().abs() @ awm.t()).numpy())


def _bf16(*shape, offset=0):
    """A bf16 (rows, cols) tensor, ``offset`` elements into its buffer."""
    rows, cols = shape
    return torch.zeros(rows * cols + offset, dtype=torch.bfloat16)[
        offset:].view(rows, cols)


@pytest.mark.parametrize("case,want", [
    ("f32", "simt"), ("bf16_rows", "wgmma"), ("bf16_forward_ragged", "wgmma"),
    ("bf16_dx_views", "wgmma"), ("bf16_dw_views", "wgmma"),
    ("bf16_row_not_16_bytes", "simt"), ("bf16_view_offset_by_one", "simt"),
    ("bf16_g_expanded", "simt"), ("bf16_g_expanded_made_contiguous", "wgmma"),
    ("bf16_mask_other_layout", "simt"), ("bf16_empty_k", "simt")])
def test_masked_matmul_route(case, want):
    """The kernel a CUDA call takes is a function of dtype, shapes,
    strides and alignment alone: TMA needs a 16-byte aligned base, one
    unit stride and the other a positive multiple of 16 bytes, and the
    mask laid out as w."""
    x, w, g = _bf16(136, 264), _bf16(264, 200), _bf16(136, 200)
    ops = {
        "f32": (x.float(), w.float(), w.float()),
        "bf16_rows": (_bf16(256, 3072), _bf16(3072, 512), _bf16(3072, 512)),
        "bf16_forward_ragged": (x, w, w.clone()),
        "bf16_dx_views": (g, w.t(), w.clone().t()),
        "bf16_dw_views": (x.t(), g, None),
        "bf16_row_not_16_bytes": (_bf16(130, 257), _bf16(257, 129), None),
        "bf16_view_offset_by_one": (_bf16(136, 264, offset=1), w, None),
        "bf16_g_expanded": (x.t(), torch.ones(
            (1, 1), dtype=torch.bfloat16).expand(136, 200), None),
        "bf16_g_expanded_made_contiguous": (x.t(), torch.ones(
            (1, 1), dtype=torch.bfloat16).expand(136, 200).contiguous(),
            None),
        "bf16_mask_other_layout": (x, w, w.t().contiguous().t()),
        "bf16_empty_k": (_bf16(8, 0), _bf16(0, 16), None),
    }[case]
    assert route(*ops) == want


@pytest.mark.parametrize("mnk,plan", [
    ((8192, 8192, 3072), (128, 1)), ((8192, 3072, 8192), (128, 1)),
    ((256, 8192, 3072), (64, 1)), ((256, 3072, 8192), (64, 2)),
    ((136, 200, 264), (64, 1)), ((72, 80, 1024), (64, 4)),
    ((1, 64, 1 << 20), (64, 256))])
def test_masked_matmul_wgmma_plan(mnk, plan):
    """128 x 128 tiles where they fill 132 SMs, else 128 x 64, then K
    split in powers of two (at least 4 steps of 64 each) until they do:
    llama3.2-3b's serve wo shape (M 256, N 3072, K 8192) gets 2 x 48 x 2
    = 192 blocks, not 48."""
    m, n, k = mnk
    assert wgmma_plan(m, n, k, 132) == plan


def test_masked_matmul_backend_never_maps_cuda_to_plain():
    """CPU tensors take the plain version; tensors on one CUDA device a
    kernel, whatever their dtype or route; anything else raises."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert backend([cpu, cpu, cpu]) == "plain"
    assert backend([cuda, cuda, cuda]) == "kernel"
    for devs in ([cpu, cuda, cuda], [cuda, torch.device("cuda", 1)],
                 [torch.device("meta")]):
        with pytest.raises(ValueError, match="one device"):
            backend(devs)


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


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_codebook_wgmma_emulation_matches_reference(x_dtype):
    """The port's wgmma route, emulated in f32 (three exact bf16 terms
    per codeword, f32 x split the same way, the kernel's products per
    16-deep K step), against the reference's oracle on the same numpy
    inputs: f32 x within rtol 1e-4 / atol 1e-4 x sqrt(K), bf16 x within
    one bf16 quantum plus 16 f32 roundoffs of sum |x||c|."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((48, 320)).astype(np.float32)
    idx = rng.integers(0, 16, (320, 80)).astype(np.int8)
    cb = np.sort(rng.standard_normal(16)).astype(np.float32)
    jx = jnp.asarray(x).astype(x_dtype)
    ref = np.asarray(j_codebook_ref(jx, jnp.asarray(idx), jnp.asarray(cb))
                     .astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    ti, tc = torch.from_numpy(idx), torch.from_numpy(cb)
    out = wgmma_emulation(tx, ti, tc).float().numpy()
    if x_dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-4,
                                   atol=1e-4 * 320 ** 0.5)
    else:
        abs_sum = (tx.float().abs() @ decode(ti, tc).abs()).numpy()
        assert _bf16_within(out, ref, abs_sum)


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
