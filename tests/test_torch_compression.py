"""Port parity: repro_torch's compression (pruning masks, fake-quant STE,
clustering, width slicing, payload model) held against repro's on the
paper MLP, on the CPU, with the same numpy-seeded inputs."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_mlp import config
from repro.core import compression as J
from repro.core.compression.pruning import _threshold as j_threshold
from repro.models import mlp as jmlp
from repro_torch.core import compression as T
from repro_torch.interop import params_from_numpy

torch.set_num_threads(1)

PLANS = list(J.DEVICE_TIERS)
# one compiled reference per plan (plans are hashable), not op by op
j_compress = jax.jit(J.compress_params, static_argnums=1)
j_mask = jax.jit(J.magnitude_mask, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _params(seed: int):
    p = jmlp.init(jax.random.PRNGKey(seed), config())
    return p, params_from_numpy(jax.tree.map(np.asarray, p))


def _leaves(tree) -> list[np.ndarray]:
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _ulp(x: np.ndarray) -> np.ndarray:
    return np.spacing(np.abs(x).astype(np.float32))


def test_leaf_order_matches_reference_flatten():
    jp, tp = _params(0)
    assert [tuple(x.shape) for x in jax.tree.leaves(jp)] == \
        [tuple(v.shape) for v in tp.values()]
    assert list(tp)[:2] == ["layers.0.b", "layers.0.w"]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("density", [0.5, 0.25, 0.1])
def test_magnitude_mask_matches_reference(seed, density):
    """Masks equal; a flip is allowed only for a weight within 4 ulps of
    the reference threshold (XLA's and torch's exp differ by an ulp)."""
    jp, tp = _params(seed)
    for jw, tw in zip(jax.tree.leaves(jp), tp.values()):
        if jw.ndim < 2:
            continue
        jm = np.asarray(j_mask(jw, density))
        tm = T.magnitude_mask(tw, density).numpy()
        diff = jm != tm
        if diff.any():
            thr = np.float32(j_threshold(jnp.abs(jw), density))
            aw = np.abs(np.asarray(jw))[diff]
            assert (np.abs(aw - thr) <= 4 * _ulp(thr)).all()


def test_batched_mask_equals_per_tensor_mask():
    """FedAvg prunes a (clients, ...) stack: each row gets its own
    threshold, equal to pruning it alone."""
    _, tp = _params(0)
    w = torch.stack([tp["layers.1.w"] * s for s in (1.0, -2.0, 0.5)])
    w[1, 0, 0] = 100.0
    batched = T.magnitude_mask(w, 0.25, batch=1)
    for i in range(3):
        assert torch.equal(batched[i], T.magnitude_mask(w[i], 0.25))


@pytest.mark.parametrize("batch", [0, 1])
@pytest.mark.parametrize("density", [0.5, 0.25, 0.1])
def test_shared_bisection_equals_per_leaf_thresholds(batch, density):
    """The bisection that a model's small leaves share
    (``pruning._shared_thresholds``: rows padded side by side): each
    leaf's threshold bitwise its own bisection's, for the paper MLP's
    ragged leaves (50, 100 and 20 weights) alone and as two clients, a
    leaf of ties and an all-zero leaf among them, and
    ``magnitude_masks`` bitwise ``magnitude_mask`` leaf by leaf."""
    from repro_torch.core.compression.pruning import (_shared_thresholds,
                                                      _threshold)
    _, tp = _params(1)
    ws = [v for k, v in tp.items() if v.dim() == 2]
    ws += [torch.full((3, 4), 0.5), torch.zeros(2, 5)]
    if batch:
        ws = [torch.stack([w, -2.0 * w]) for w in ws]
    aws = [w.abs() for w in ws]
    for aw, t in zip(aws, _shared_thresholds(aws, density, batch)):
        want = _threshold(aw, density, batch)
        assert t.shape == want.shape and torch.equal(t, want)
    got = T.magnitude_masks(dict(enumerate(ws)), density, batch)
    for i, w in enumerate(ws):
        assert torch.equal(got[i], T.magnitude_mask(w, density, batch))


@pytest.mark.parametrize("tier", PLANS)
@pytest.mark.parametrize("seed", [0, 1])
def test_compress_params_matches_reference(tier, seed):
    """Bitwise where the masks agree; the clustered tier to atol 1e-6
    (its Lloyd update sums one-hot products in another order)."""
    plan_j, plan_t = J.DEVICE_TIERS[tier], T.DEVICE_TIERS[tier]
    assert plan_t == T.CompressionPlan(**vars(plan_j))
    jp, tp = _params(seed)
    jc, jm = j_compress(jp, plan_j)
    tc, tm = T.compress_params(tp, plan_t)
    for a, b, ma, mb in zip(_leaves(jc), tc.values(), _leaves(jm),
                            tm.values()):
        b, mb = b.detach().numpy(), mb.numpy()
        agree = np.broadcast_to(ma == mb, a.shape)
        if plan_t.cluster_k:
            if agree.all():
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
        else:
            assert np.array_equal(a[agree], b[agree])


def test_fake_quant_ste_gradient_bitwise():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4000) * 300).astype(np.float32)
    c = rng.standard_normal(4000).astype(np.float32)
    for e, m in [(4, 3), (5, 2), (2, 1), (0, 8)]:
        gj = np.asarray(jax.grad(lambda v: jnp.sum(
            J.fake_quant_ste(v, e, m) * c))(jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_(True)
        (T.fake_quant_ste(xt, e, m) * torch.from_numpy(c)).sum().backward()
        assert np.array_equal(gj, xt.grad.numpy())


def test_cluster_ste_matches_reference():
    """Codebook reconstruction to atol 1e-6 (the ``oh.T @ flat`` sum
    order); the backward is the identity in both."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((40, 30)).astype(np.float32)
    a = np.asarray(J.cluster_ste(jnp.asarray(w), 16))
    wt = torch.from_numpy(w).requires_grad_(True)
    b = T.cluster_ste(wt, 16)
    np.testing.assert_allclose(b.detach().numpy(), a, rtol=0, atol=1e-6)
    b.sum().backward()
    assert torch.equal(wt.grad, torch.ones_like(wt))


@pytest.mark.parametrize("width", [1.0, 0.5, 0.25])
def test_width_slicing_matches_reference(width):
    jp, tp = _params(0)
    js, ts = J.submodel_spec(jp, width), T.submodel_spec(tp, width)
    assert (ts.slices, ts.shapes, ts.is_identity, ts.local_size()) == \
        (js.slices, js.shapes, js.is_identity, js.local_size())
    for a, b in zip(_leaves(J.slice_tree(jp, js)),
                    T.slice_tree(tp, ts).values()):
        assert np.array_equal(a, b.numpy())
    for tier in PLANS:
        pj = J.CompressionPlan(**{**vars(J.DEVICE_TIERS[tier]), "width": width})
        pt = T.CompressionPlan(**{**vars(T.DEVICE_TIERS[tier]), "width": width})
        _, jm = j_compress(jp, pj)
        _, tm = T.compress_params(tp, pt)
        for a, b in zip(_leaves(jm), tm.values()):
            assert np.array_equal(np.broadcast_to(a, b.shape), b.numpy())


@pytest.mark.parametrize("width", [None, 1.0, 0.5, 0.25])
def test_payload_and_active_counts_match_reference(width):
    jp, tp = _params(0)
    for tier in PLANS:
        pj, pt = J.DEVICE_TIERS[tier], T.DEVICE_TIERS[tier]
        if width is not None:
            pj = J.CompressionPlan(**{**vars(pj), "width": width})
            pt = T.CompressionPlan(**{**vars(pt), "width": width})
        assert T.payload_bits(tp, pt) == J.payload_bits(jp, pj)
        assert T.active_param_count(tp, pt) == J.active_param_count(jp, pj)
