"""Port parity: mask-aware aggregation (accumulate/scatter -> finalize)
BITWISE, and the Eq. (1) time model EXACTLY equal in float64, against
the reference on the paper MLP."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_mlp import config
from repro.core import aggregation as JA
from repro.core import compression as JC
from repro.core import heterogeneity as JH
from repro.models import mlp as jmlp
from repro_torch.core import aggregation as TA
from repro_torch.core import compression as TC
from repro_torch.core import heterogeneity as TH
from repro_torch.interop import params_from_numpy

torch.set_num_threads(1)

TIERS = ("hub", "high", "mid", "low", "embedded")


def _setup(width: bool, seed: int = 0):
    """Reference and port params plus, per tier, the same random
    update-sum at the tier's local shapes and its masks."""
    jp = jmlp.init(jax.random.PRNGKey(seed), config())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(seed)
    tiers = []
    for name in TIERS:
        pj, pt = JC.DEVICE_TIERS[name], TC.DEVICE_TIERS[name]
        if width:
            pj, pt = pj.as_width_sliced(), pt.as_width_sliced()
        spec_j = JC.submodel_spec(jp, pj.width) if width else None
        spec_t = TC.submodel_spec(tp, pt.width) if width else None
        local = TC.slice_tree(tp, spec_t) if width else tp
        _, m_t = TC.compress_params(local, pt.inner())
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * 3
             for k, v in local.items()}
        g_j = jax.tree.unflatten(jax.tree.structure(jp),
                                 [jnp.asarray(v) for v in g.values()])
        m_j = jax.tree.unflatten(jax.tree.structure(jp),
                                 [jnp.asarray(m.numpy()) for m in m_t.values()])
        g_t = {k: torch.from_numpy(v) for k, v in g.items()}
        tiers.append((spec_j, spec_t, g_j, g_t, m_j, m_t, pt.weight,
                      float(rng.integers(0, 6))))
    return jp, tp, tiers


@pytest.mark.parametrize("width", [False, True])
def test_scatter_accumulate_finalize_bitwise(width):
    jp, tp, tiers = _setup(width)
    acc_j = JA.zeros_like_acc(jp, dense_den=width)
    acc_t = TA.zeros_like_acc(tp, dense_den=width)
    for spec_j, spec_t, g_j, g_t, m_j, m_t, w, n in tiers:
        acc_j = JA.scatter_accumulate(acc_j, g_j, m_j, spec_j,
                                      jnp.float32(w), jnp.float32(n))
        acc_t = TA.scatter_accumulate(acc_t, g_t, m_t, spec_t, w, n)
    out_j = [np.asarray(x) for x in jax.tree.leaves(JA.finalize(acc_j))]
    out_t = [v.numpy() for v in TA.finalize(acc_t).values()]
    for a, b in zip(out_j, out_t):
        assert a.shape == b.shape
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("width", [False, True])
def test_scatter_accumulate_coverage_bitwise(width):
    """The fault layer's coverage denominator (``cov=``, integer-valued
    per coordinate at the tier's local shapes), with and without a
    staleness weight: the finalized aggregate is the reference's bit for
    bit."""
    jp, tp, tiers = _setup(width, seed=1)
    rng = np.random.default_rng(7)
    acc_j = JA.zeros_like_acc(jp, dense_den=True)
    acc_t = TA.zeros_like_acc(tp, dense_den=True)
    for i, (spec_j, spec_t, g_j, g_t, m_j, m_t, w, n) in enumerate(tiers):
        cov = {k: rng.integers(0, int(n) + 1, v.shape).astype(np.float32)
               for k, v in g_t.items()}
        cov_j = jax.tree.unflatten(jax.tree.structure(jp),
                                   [jnp.asarray(v) for v in cov.values()])
        s = None if i % 2 else 0.7071067811865476
        acc_j = JA.scatter_accumulate(
            acc_j, g_j, m_j, spec_j, jnp.float32(w), jnp.float32(n),
            staleness_weight=None if s is None else jnp.float32(s),
            cov=cov_j)
        acc_t = TA.scatter_accumulate(
            acc_t, g_t, m_t, spec_t, w, n, staleness_weight=s,
            cov={k: torch.from_numpy(v) for k, v in cov.items()})
    out_j = [np.asarray(x) for x in jax.tree.leaves(JA.finalize(acc_j))]
    out_t = [v.numpy() for v in TA.finalize(acc_t).values()]
    for a, b in zip(out_j, out_t):
        assert a.shape == b.shape
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("local_steps", [1, 5])
@pytest.mark.parametrize("width", [False, True])
def test_cohort_round_time_exact(local_steps, width):
    jp = jmlp.init(jax.random.PRNGKey(0), config())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    profiles = ["hub", "low", "embedded", "mid"]
    for name in TIERS:
        pj, pt = JC.DEVICE_TIERS[name], TC.DEVICE_TIERS[name]
        if width:
            pj, pt = pj.as_width_sliced(), pt.as_width_sliced()
        a = JH.cohort_round_time(jp, pj, [JH.PROFILES[p] for p in profiles],
                                 16, local_steps)
        b = TH.cohort_round_time(tp, pt, [TH.PROFILES[p] for p in profiles],
                                 16, local_steps)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.float64
            assert np.array_equal(a[k], b[k])
        assert TH.round_time(tp, pt, TH.PROFILES["mid"], 16) == \
            JH.round_time(jp, pj, JH.PROFILES["mid"], 16)
