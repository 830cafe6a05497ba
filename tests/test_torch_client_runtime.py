"""The port's per-client runtime (``runtime="client"``, FLServer) against
the reference: the same scenario JSON, the reference's params and
ragged Dirichlet shards carried across through numpy, two rounds of
FedSGD, FedAvg, fp8 uploads with error feedback and width-sliced
tiers. Plus the Dirichlet partition, the memory model, and the port's
per-client loop against its own cohort runtime."""
import json
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_mlp import config
from repro.core import heterogeneity as JH
from repro.core import scenario as J
from repro.core.compression import DEVICE_TIERS as J_TIERS
from repro.data import partition_dirichlet as j_partition_dirichlet
from repro.models import mlp as jmlp
import repro_torch.fl as T
from repro_torch import optim
from repro_torch.core import heterogeneity as TH
from repro_torch.core.compression import DEVICE_TIERS as T_TIERS
from repro_torch.data import partition_dirichlet
from repro_torch.interop import (params_from_numpy, params_to_numpy,
                                 shards_from_numpy)
from repro_torch.models import mlp as tmlp

torch.set_num_threads(1)

# three plans (quantized, pruned + quantized, clustered) over four
# clients: the reference compiles each client's step once per shard size,
# and Dirichlet shard sizes differ
FLEET = ("high", "low", "embedded", "low")
NONIID = dict(tiers=FLEET, n_samples=160, partition="dirichlet", alpha=0.5)

SCENARIOS = {
    "fedsgd": J.FLScenario(fleet=J.FleetSpec(**NONIID), runtime="client"),
    "fedavg": J.FLScenario(
        fleet=J.FleetSpec(**NONIID), runtime="client",
        local=J.LocalTraining(mode="fedavg", local_steps=2, local_lr=1.0)),
    "fp8_ef": J.FLScenario(
        fleet=J.FleetSpec(**NONIID), runtime="client",
        upload=J.UploadPolicy(quant="fp8_e4m3", error_feedback=True)),
    "width": J.FLScenario(
        fleet=J.FleetSpec(**NONIID), runtime="client",
        local=J.LocalTraining(submodel="width")),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_client_runtime_matches_reference(name, rounds=2):
    """Losses and per-client losses to rtol 1e-5, params to atol 1e-5
    (PR 11's bar: matmul and sum orders differ); Eq. (1) wall time,
    bytes and participants exactly (host float64)."""
    sc = SCENARIOS[name]
    params = jmlp.init(jax.random.PRNGKey(0), config())
    shards = [jax.tree.map(np.asarray, c.data)
              for c in sc.fleet.build_clients()]
    assert len({len(s["y"]) for s in shards}) > 1          # ragged shards
    port_sc = T.FLScenario.from_dict(json.loads(json.dumps(sc.to_dict())))
    ref = J.simulate(sc, rounds, params=params, shards=shards)
    out = T.simulate(port_sc, rounds, device="cpu", engine="scan",
                     params=params_from_numpy(jax.tree.map(np.asarray,
                                                           params)),
                     shards=shards_from_numpy(shards))
    assert type(out.server).__name__ == "FLServer"
    assert out.agg_backend == ref.agg_backend == "sequential"
    np.testing.assert_allclose(out.losses, ref.losses, rtol=1e-5)
    for a, b in zip(ref.records, out.records):
        np.testing.assert_allclose(b.client_losses, a.client_losses,
                                   rtol=1e-5)
        assert (b.step, b.n_participants, b.round_wall_time,
                b.total_upload_bytes) == (a.step, a.n_participants,
                                          a.round_wall_time,
                                          a.total_upload_bytes)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, ref.params)),
                    jax.tree.leaves(params_to_numpy(out.params))):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    if name == "fp8_ef":
        for c in out.server.clients:
            assert all(c.ef_buffer[k].dtype == p.dtype
                       for k, p in out.params.items())


@pytest.mark.parametrize("n_clients,alpha,key", [(8, 0.5, 0), (5, 0.1, 1),
                                                 (3, 10.0, 2)])
def test_partition_dirichlet_index_sets_match_reference(n_clients, alpha,
                                                        key):
    """Handed the integer seed that the reference draws from its key, the
    port gives the reference's index sets, element for element (x
    carries each sample's index)."""
    rng = np.random.default_rng(0)
    data = {"x": np.arange(500, dtype=np.float32)[:, None],
            "y": rng.integers(0, 2, 500).astype(np.int32)}
    jkey = jax.random.PRNGKey(key)
    seed = int(jax.random.randint(jkey, (), 0, 2**31 - 1))
    theirs = j_partition_dirichlet(jkey, data, n_clients, alpha)
    ours = partition_dirichlet(seed, {k: torch.from_numpy(v)
                                      for k, v in data.items()},
                               n_clients, alpha)
    assert len(ours) == len(theirs) == n_clients
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a["x"].numpy(), np.asarray(b["x"]))
        np.testing.assert_array_equal(a["y"].numpy(), np.asarray(b["y"]))
    got = np.sort(np.concatenate([s["x"].numpy()[:, 0] for s in ours]))
    np.testing.assert_array_equal(got, np.arange(500))


def test_dirichlet_fleet_build_is_deterministic():
    spec = T.FleetSpec(**{**NONIID, "tiers": FLEET + FLEET}, data_seed=3)
    a, b = spec.build_clients(), spec.build_clients()
    sizes = [len(c.data["y"]) for c in a]
    assert sum(sizes) == spec.n_samples and len(set(sizes)) > 1
    for ca, cb in zip(a, b):
        assert torch.equal(ca.data["x"], cb.data["x"])


@pytest.mark.parametrize("tier", sorted(T_TIERS))
@pytest.mark.parametrize("width", [False, True])
def test_memory_overhead_and_fits_match_reference(tier, width):
    """Host float64 arithmetic on shapes: exactly equal."""
    jp = jmlp.init(jax.random.PRNGKey(0), config())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    pj, pt = J_TIERS[tier], T_TIERS[tier]
    if width:
        pj, pt = pj.as_width_sliced(), pt.as_width_sliced()
    for slots in (0, 1, 2):
        for batch, act in ((1, 0.0), (64, 4096.0), (10**6, 1e3)):
            assert TH.memory_overhead(tp, pt, batch, act, slots) == \
                JH.memory_overhead(jp, pj, batch, act, slots)
            for prof in TH.PROFILES:
                assert TH.fits(tp, pt, TH.PROFILES[prof], batch, act, slots) \
                    == JH.fits(jp, pj, JH.PROFILES[prof], batch, act, slots)
    with pytest.raises(ValueError, match="opt_slots"):
        TH.memory_overhead(tp, pt, 1, opt_slots=-1)


@pytest.mark.parametrize("mode,kw", [
    ("fedsgd", {}),
    ("fedavg", {"local_steps": 2, "local_lr": 0.5}),
    ("fedsgd", {"upload_quant": "fp8_e4m3", "error_feedback": True}),
])
def test_client_round_matches_port_cohort_round(mode, kw):
    """The port's own per-client loop and cohort runtime on equal IID
    shards: params within 1e-5 after two rounds (the reference's
    test_cohort_round_matches_per_client_loop bound), the loss to 1e-5
    and the Eq. (1) numbers to rtol 1e-6."""
    fleet = T.FleetSpec.cycling(("hub", "high", "mid", "low", "mid", "low"),
                                6, samples_per_client=16)
    model = types.SimpleNamespace(loss_fn=tmlp.loss_fn)
    params = tmlp.init(torch.Generator().manual_seed(0), config())
    loop = T.FLServer(model=model, optimizer=optim.sgd(1.0),
                      clients=fleet.build_clients(), params=params,
                      mode=mode, **kw)
    coh = T.CohortFLServer.from_clients(
        fleet.build_clients(), "cpu", model=model, optimizer=optim.sgd(1.0),
        params=params, mode=mode, **kw)
    for _ in range(2):
        rl, rc = loop.round(), coh.round()
    assert max((loop.params[k] - coh.params[k]).abs().max().item()
               for k in params) < 1e-5
    assert rl["loss"] == pytest.approx(rc["loss"], abs=1e-5)
    assert rl["round_wall_time"] == pytest.approx(rc["round_wall_time"],
                                                 rel=1e-6)
    assert rl["total_upload_bytes"] == pytest.approx(
        rc["total_upload_bytes"], rel=1e-6)


def test_client_runtime_refuses_what_it_cannot_run():
    fleet = T.FleetSpec.cycling(("hub", "low"), 2)
    with pytest.raises(ValueError, match="SyncWait"):
        T.FLScenario(fleet=fleet, runtime="client",
                     timing=T.SyncDrop(deadline=1.0))
    with pytest.raises(ValueError, match="participation"):
        T.FLScenario(fleet=fleet, runtime="client",
                     participation=T.ParticipationPolicy(fraction=0.5))
