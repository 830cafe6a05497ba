"""Port parity: the one-cohort round step (``cohort_step_fn``) in all
three branches — grad-of-sum FedSGD, per-client FedSGD under upload
quantization with error feedback, FedAvg local SGD — for every
DEVICE_TIERS plan, masked and width-sliced, against the reference on
the CPU with the same params, batches and participation."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_mlp import config
from repro.core import federated as JF
from repro.core.compression import DEVICE_TIERS as J_TIERS
from repro.models import mlp as jmlp
from repro_torch.core import federated as TF
from repro_torch.core.compression import DEVICE_TIERS as T_TIERS
from repro_torch.interop import params_from_numpy
from repro_torch.models import mlp as tmlp

torch.set_num_threads(1)

J_MODEL = types.SimpleNamespace(loss_fn=jmlp.loss_fn)
BRANCHES = {"fedsgd": ("fedsgd", None), "fedsgd_quant": ("fedsgd", "fp8_e4m3"),
            "fedavg": ("fedavg", None)}
C, N = 3, 8


def _inputs(seed=0):
    jp = jmlp.init(jax.random.PRNGKey(seed), config())
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, N, 5)).astype(np.float32)
    y = rng.integers(0, 2, (C, N)).astype(np.int32)
    part = np.array([1.0, 0.0, 1.0], np.float32)
    return jp, x, y, part


@pytest.mark.parametrize("submodel", ["mask", "width"])
@pytest.mark.parametrize("tier", sorted(T_TIERS))
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_cohort_step_matches_reference(branch, tier, submodel):
    """update_sum, loss_sum and EF residuals to rtol 1e-5 / atol 1e-6
    (matmul and client-sum orders differ); masks exactly."""
    mode, fmt = BRANCHES[branch]
    pj, pt = J_TIERS[tier], T_TIERS[tier]
    if submodel == "width":
        pj, pt = pj.as_width_sliced(), pt.as_width_sliced()
    jp, x, y, part = _inputs()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    j_ef = (JF._init_cohort_ef(C, JF._local_param_struct(jp, pj))
            if fmt else ())
    t_ef = (TF._init_cohort_ef(C, TF._local_param_struct(tp, pt))
            if fmt else {})
    j_out = JF._cohort_step_jit(J_MODEL.loss_fn, pj, mode, 2, 0.5, fmt)(
        jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jnp.asarray(part), j_ef)
    t_out = TF.cohort_step_fn(tmlp.loss_fn, pt, mode, 2, 0.5, fmt)(
        tp, {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()},
        torch.from_numpy(part), t_ef)
    (jg, jm, jl, jef), (tg, tm, tl, tef) = j_out, t_out
    for a, b in zip(jax.tree.leaves(jg), tg.values()):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=1e-5, atol=1e-6)
    for a, b in zip(jax.tree.leaves(jm), tm.values()):
        assert np.array_equal(np.asarray(a), b.numpy())
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)
    for a, b in zip(jax.tree.leaves(jef), tef.values()):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
