"""The port's twin of the reference's test
``test_structured_low_tier_loses_no_global_coordinates``
(``tests/test_structured.py``): a full-width hub and a 0.25-width tier,
8 rounds of the cohort runtime under ``sgd(1.0)``, the reference's
params and shards carried across through ``repro_torch.interop``. The
reference test asserts that the last round's loss is below the first;
at this step size both packages overshoot (the loss rises after round 1
and falls below it only from round 9 on), so that assertion fails in the
reference itself. The twin holds the port's loss history to the
reference's instead (rtol 1e-5), and that every global coordinate still
moved."""
import types

import jax
import numpy as np
import torch

from repro import optim as j_optim
from repro.configs.paper_mlp import config
from repro.core.compression import DEVICE_TIERS as J_TIERS
from repro.core.federated import Client as JClient
from repro.core.federated import CohortFLServer as JServer
from repro.data import make_gaussian_dataset, partition_iid
from repro.models import mlp as jmlp
from repro_torch import optim as t_optim
from repro_torch.core.compression import DEVICE_TIERS as T_TIERS
from repro_torch.core.federated import Client as TClient
from repro_torch.core.federated import CohortFLServer as TServer
from repro_torch.interop import (params_from_numpy, params_to_numpy,
                                 shards_from_numpy)
from repro_torch.models import mlp as tmlp

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
ROUNDS = 8


def test_structured_low_tier_loss_history_matches_reference():
    """Losses of all 8 rounds to rtol 1e-5 of the reference's, the
    rounds after the first above it in both (the overshoot that makes
    the reference's own loss-drop assertion fail), and every coordinate
    of the final params moved from the initial ones in both."""
    data = make_gaussian_dataset(KEY, 128)
    shards = partition_iid(KEY, data, 2)
    params = jmlp.init(KEY, config())
    j_plans = [J_TIERS["hub"], J_TIERS["low"].as_width_sliced()]
    t_plans = [T_TIERS["hub"], T_TIERS["low"].as_width_sliced()]
    ref = JServer.from_clients(
        [JClient(i, p, shards[i], profile_name="mid")
         for i, p in enumerate(j_plans)],
        model=types.SimpleNamespace(loss_fn=jmlp.loss_fn),
        optimizer=j_optim.sgd(1.0), params=params)
    np_shards = shards_from_numpy([jax.tree.map(np.asarray, s)
                                   for s in shards])
    init = params_from_numpy(jax.tree.map(np.asarray, params))
    port = TServer.from_clients(
        [TClient(i, p, np_shards[i], profile_name="mid")
         for i, p in enumerate(t_plans)], device="cpu",
        model=types.SimpleNamespace(loss_fn=tmlp.loss_fn),
        optimizer=t_optim.sgd(1.0), params=dict(init))
    assert [c.plan.width for c in port.cohorts] == [
        c.plan.width for c in ref.cohorts]
    for _ in range(ROUNDS):
        ref.round()
        port.round()
    j_loss = [h["loss"] for h in ref.history]
    t_loss = [h["loss"] for h in port.history]
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    assert all(loss > j_loss[0] for loss in j_loss[1:])
    assert all(loss > t_loss[0] for loss in t_loss[1:])
    final = params_to_numpy(port.params)
    for a, b, c in zip(jax.tree.leaves(jax.tree.map(np.asarray, params)),
                       jax.tree.leaves(final),
                       jax.tree.leaves(jax.tree.map(np.asarray, ref.params))):
        assert np.all(b != a) and np.all(c != a)
