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
from repro_torch.kernels.grad_aggregate import grad_aggregate
from repro_torch.kernels.grad_aggregate.ref import grad_aggregate_ref
from repro_torch.kernels.structured_scatter import structured_scatter_batched
from repro_torch.kernels.structured_scatter.ops import structured_scatter

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
