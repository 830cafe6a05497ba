"""The port's aggregation kernels. On the CPU the wrappers take their
plain versions, held against the reference's Pallas kernels (interpret
mode off the TPU) with the same numpy inputs. The CUDA kernels
themselves are held against the plain versions in
test_torch_kernels_cuda.py."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grad_aggregate import grad_aggregate as j_grad_aggregate
from repro.kernels.structured_scatter.ops import (
    structured_scatter as j_scatter,
    structured_scatter_batched as j_scatter_batched)
from repro_torch.core.aggregation import (accumulate_cohort, f32, finalize)
from repro_torch.kernels.grad_aggregate import grad_aggregate
from repro_torch.kernels.structured_scatter import (
    structured_scatter, structured_scatter_batched)
from repro_torch.kernels.grad_aggregate.ref import grad_aggregate_ref
from repro_torch.kernels.structured_scatter.ref import structured_scatter_ref

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = np.array([1.0, 0.5, 2.0, 1.0], np.float32)
N_PART = np.array([3.0, 0.0, 5.0, 1.0], np.float32)


def _agg_inputs(shape, scalar_masks: bool, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((4,) + shape).astype(np.float32)
    if scalar_masks:
        m = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    else:
        m = (rng.random((4,) + shape) < 0.6).astype(np.float32)
    return g, m


@pytest.mark.parametrize("shape", [(1001,), (7, 13), (5, 10), (3, 4, 9)])
@pytest.mark.parametrize("scalar_masks", [False, True])
def test_grad_aggregate_cpu_matches_reference(shape, scalar_masks):
    """Tolerance atol 1e-6: the reference kernel sums wn*m*g over the
    tier axis in one reduction, the port folds tiers in cohort order."""
    g, m = _agg_inputs(shape, scalar_masks)
    wd = W * N_PART
    ref = np.asarray(j_grad_aggregate(jnp.asarray(g), jnp.asarray(m),
                                      jnp.asarray(W), w_den=jnp.asarray(wd)))
    out = grad_aggregate(torch.from_numpy(g), torch.from_numpy(m),
                         torch.from_numpy(W), w_den=torch.from_numpy(wd))
    assert out.shape == shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_grad_aggregate_is_the_accumulate_finalize_chain():
    """The chosen kernel arithmetic: bitwise the port's cohort chain."""
    g, m = _agg_inputs((10, 10), False, seed=3)
    out = grad_aggregate(torch.from_numpy(g), torch.from_numpy(m), W,
                         w_den=[f32(w * n) for w, n in zip(W, N_PART)])
    acc = ({"x": torch.zeros(10, 10)}, {"x": torch.zeros(10, 10)})
    for t in range(4):
        acc = accumulate_cohort(acc, {"x": torch.from_numpy(g[t])},
                                {"x": torch.from_numpy(m[t])}, float(W[t]),
                                float(N_PART[t]))
    assert torch.equal(out, finalize(acc)["x"])


# leaf shape -> per-tier local shapes (prefix slices, full-width tiers
# first as in a mixed fleet) and which tiers carry scalar masks
SCATTER_CASES = {
    "1d": ((10,), [(10,), (10,), (5,), (3,)], [True, True, True, True]),
    "2d": ((10, 10), [(10, 10), (10, 10), (5, 5), (3, 3)],
           [False, False, False, False]),
    "2d_edge": ((5, 10), [(5, 10), (5, 10), (5, 5), (5, 3)],
                [False, True, False, True]),
    "3d": ((4, 3, 6), [(4, 3, 6), (4, 3, 6), (2, 3, 3), (1, 3, 2)],
           [False, False, True, False]),
}


def _same_values(a: np.ndarray, b: np.ndarray) -> bool:
    """Bitwise up to the sign of zero: the reference's compiled kernel
    lets XLA fold its ``0 + x`` first add to ``x``, which keeps a -0.0
    that the IEEE add (the port's, and the reference's own op-by-op
    chain) turns into +0.0. Every nonzero value has the same bits."""
    nz = (a != 0) | (b != 0)
    return (a.shape == b.shape and np.array_equal(a, b)
            and np.array_equal(a[nz].view(np.uint32), b[nz].view(np.uint32)))


def _scatter_inputs(case, L=None, seed=0):
    shape, locals_, scalar = SCATTER_CASES[case]
    rng = np.random.default_rng(seed)
    lead = () if L is None else (L,)
    gs = [rng.standard_normal(lead + s).astype(np.float32) for s in locals_]
    ms = [np.ones(lead, np.float32) if sc
          else (rng.random(lead + s) < 0.7).astype(np.float32)
          for s, sc in zip(locals_, scalar)]
    return shape, gs, ms


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_structured_scatter_cpu_bitwise(case):
    shape, gs, ms = _scatter_inputs(case)
    wd = W * N_PART
    ref = np.asarray(j_scatter([jnp.asarray(g) for g in gs],
                               [jnp.asarray(m) for m in ms], jnp.asarray(W),
                               jnp.asarray(wd), out_shape=shape))
    args = ([torch.from_numpy(g) for g in gs],
            [torch.from_numpy(m) for m in ms], W, wd)
    out = structured_scatter(*args, out_shape=shape).numpy()
    assert _same_values(out, ref)
    plain = structured_scatter_ref(*args, out_shape=shape).numpy()
    assert np.array_equal(out.view(np.uint32), plain.view(np.uint32))


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_structured_scatter_batched_cpu_bitwise(case):
    shape, gs, ms = _scatter_inputs(case, L=3, seed=1)
    wd = W * N_PART
    ref = np.asarray(j_scatter_batched(
        [jnp.asarray(g) for g in gs], [jnp.asarray(m) for m in ms],
        jnp.asarray(W), jnp.asarray(wd), out_shape=shape))
    out = structured_scatter_batched(
        [torch.from_numpy(g) for g in gs], [torch.from_numpy(m) for m in ms],
        W, wd, out_shape=shape).numpy()
    assert out.shape == (3,) + shape
    assert _same_values(out, ref)


def test_wrappers_take_no_other_device():
    """No fallback: a tensor that is neither on the CPU nor on CUDA is
    refused, it is not computed somewhere else."""
    g = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError):
        grad_aggregate(g, g, [1.0, 1.0])
    with pytest.raises(ValueError):
        structured_scatter([g[0], g[1]], [g[0], g[1]], [1.0, 1.0],
                           out_shape=(8,))


def test_kernel_modules_import_without_nvcc_or_gpu():
    code = ("import torch\n"
            "from repro_torch.kernels import build\n"
            "from repro_torch.kernels.grad_aggregate import grad_aggregate\n"
            "g = torch.ones(2, 5)\n"
            "assert grad_aggregate(g, g, [1.0, 1.0]).shape == (5,)\n"
            "assert not build._libs\n")
    env = {**os.environ, "PATH": "/nonexistent", "CUDA_HOME": "/nonexistent",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
