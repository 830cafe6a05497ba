"""Hierarchical fleets, the port against the reference on the CPU: the
five topology scenarios of ``tests/test_topology.py`` for 5 rounds with
the reference's params and shards carried across (losses rtol 1e-5,
params atol 1e-5: the reference's vmapped edge step is its own numerical
reference, so this is the FL tolerance, not bitwise; participants,
drops, Eq. (1) wall-clock and bytes exactly), the edge grids cell for
cell, the census's topology fields and ``cross_shard_bytes``, and a
topology checkpoint with fp8 EF rows crossing both ways."""
import json
import shutil
import tempfile
import types

import jax
import numpy as np
import pytest
import torch

from repro import optim as j_optim
from repro.checkpoint.state import restore_run_state as j_restore
from repro.configs.paper_mlp import config
from repro.core import scenario as J
from repro.core import topology as JT
from repro.core.compression import DEVICE_TIERS as J_TIERS
from repro.models import mlp as jmlp
import repro_torch.fl as T
from repro_torch.core.compression import DEVICE_TIERS as T_TIERS
from repro_torch.interop import (params_from_numpy, params_to_numpy,
                                 shards_from_numpy)

torch.set_num_threads(1)

TIERS = ("hub", "high", "mid", "low")
J_PARAMS = jmlp.init(jax.random.PRNGKey(3), config())
T_PARAMS = params_from_numpy(jax.tree.map(np.asarray, J_PARAMS))


def _fleet(n, edges):
    return J.FleetSpec.cycling(TIERS, n, samples_per_client=8, edges=edges)


SCENARIOS = {
    "sync_wait": J.FLScenario(
        fleet=_fleet(16, 4),
        participation=J.ParticipationPolicy(fraction=0.5, seed=11)),
    "sync_drop": J.FLScenario(fleet=_fleet(16, 4),
                              timing=J.SyncDrop(deadline=0.004)),
    "fedavg": J.FLScenario(
        fleet=_fleet(8, 4),
        local=J.LocalTraining(mode="fedavg", local_steps=3, local_lr=0.5)),
    "quant_ef": J.FLScenario(
        fleet=_fleet(8, 4),
        upload=J.UploadPolicy(quant="fp8_e4m3", error_feedback=True),
        participation=J.ParticipationPolicy(fraction=0.6, seed=5)),
    "width": J.FLScenario(fleet=_fleet(8, 4),
                          local=J.LocalTraining(submodel="width")),
}


def _port(sc):
    out = T.FLScenario.from_dict(json.loads(json.dumps(sc.to_dict())))
    assert out.to_dict() == sc.to_dict()
    return out


def _shards(sc):
    return [jax.tree.map(np.asarray, c.data)
            for c in sc.fleet.build_clients()]


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


def _close(port_params, ref_params):
    for a, b in zip(_leaves(ref_params),
                    jax.tree.leaves(params_to_numpy(port_params))):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_topology_matches_reference(name):
    sc = SCENARIOS[name]
    shards = _shards(sc)
    ref = J.simulate(sc, 5, params=J_PARAMS, shards=shards)
    out = T.simulate(_port(sc), 5, params=T_PARAMS, device="cpu",
                     shards=shards_from_numpy(shards))
    np.testing.assert_allclose(out.losses, ref.losses, rtol=1e-5)
    _close(out.params, ref.params)
    for a, b in zip(ref.records, out.records):
        assert (b.step, b.n_participants, b.n_dropped, b.round_wall_time,
                b.total_upload_bytes) == \
            (a.step, a.n_participants, a.n_dropped, a.round_wall_time,
             a.total_upload_bytes)


@pytest.mark.parametrize("n,edges,kind", [(16, 4, "contiguous"),
                                          (10, 3, "contiguous"),
                                          (12, 4, "round_robin")])
def test_edge_grids_equal_reference(n, edges, kind):
    """Plans, flat metadata, (edge, row) cells, cap and every grid cell
    (padding included) equal to the reference's ``build_edge_cohorts``."""
    spec = J.FleetSpec.cycling(TIERS, n, samples_per_client=4)
    topo = getattr(JT.FleetTopology, kind)(n, edges)
    j_clients = spec.build_clients()
    t_spec = T.FleetSpec.from_dict({**spec.to_dict(),
                                    "topology": topo.to_dict()})
    t_clients = t_spec.build_clients(shards_from_numpy(
        [jax.tree.map(np.asarray, c.data) for c in j_clients]))
    ref = JT.build_edge_cohorts(j_clients, topo)
    out = T.build_edge_cohorts(t_clients, t_spec.topology, "cpu")
    assert len(ref) == len(out)
    for a, b in zip(ref, out):
        assert a.plan.name == b.plan.name
        assert (a.client_ids, a.profile_names, a.n_edges, a.cap) == \
            (b.client_ids, b.profile_names, b.n_edges, b.cap)
        assert np.array_equal(a.edge_index, b.edge_index)
        assert np.array_equal(a.row_index, b.row_index)
        for k in a.data:
            assert np.array_equal(np.asarray(a.data[k]),
                                  b.data[k].numpy().astype(
                                      np.asarray(a.data[k]).dtype))
        part = np.arange(a.size) % 3 == 0
        assert np.array_equal(JT.scatter_part(a, part),
                              T.scatter_part(b, part))


@pytest.mark.parametrize("name", ["sync_drop", "fedavg", "width"])
def test_census_topology_fields_equal_reference(name):
    sc = SCENARIOS[name]
    ref = J.scenario_census(sc)
    out = T.scenario_census(_port(sc))
    for key in ("n_edges", "cross_shard_bytes_per_round", "edge_groups",
                "round_wall_time", "total_upload_bytes_per_round"):
        assert out[key] == ref[key], key


@pytest.mark.parametrize("width", [False, True])
def test_cross_shard_bytes_equals_reference(width):
    plans_j = [J_TIERS[t] for t in TIERS + ("embedded",)]
    plans_t = [T_TIERS[t] for t in TIERS + ("embedded",)]
    if width:
        plans_j = [p.as_width_sliced() for p in plans_j]
        plans_t = [p.as_width_sliced() for p in plans_t]
    for e in (1, 4, 8):
        assert T.cross_shard_bytes(T_PARAMS, plans_t, e) == \
            JT.cross_shard_bytes(J_PARAMS, plans_j, e)


ROUNDS, CUT = 6, 3


def test_topology_checkpoints_cross_packages():
    """A reference topology run with fp8 EF rows checkpointed at round 3
    resumes in the port within the FL tolerance of the reference's
    uninterrupted run; a port checkpoint restores in the reference with
    equal params and ``(E, cap, ...)`` EF grids, and the reference
    continues it to its own run's end within the same tolerance."""
    sc = SCENARIOS["quant_ef"]
    t_sc = _port(sc)
    shards = _shards(sc)
    t_kw = dict(device="cpu", params=T_PARAMS,
                shards=shards_from_numpy(shards))
    d = tempfile.mkdtemp()
    try:
        full = J.simulate(sc, ROUNDS, params=J_PARAMS, shards=shards)
        J.simulate(sc, CUT, params=J_PARAMS, shards=shards,
                   checkpoint_every=CUT, checkpoint_dir=d)
        out = T.simulate(t_sc, ROUNDS, resume_from=d, **t_kw)
        np.testing.assert_allclose(out.losses, full.losses, rtol=1e-5)
        _close(out.params, full.params)

        shutil.rmtree(d)
        port = T.simulate(t_sc, CUT, checkpoint_every=CUT, checkpoint_dir=d,
                          **t_kw)
        srv = J.build_server(sc, types.SimpleNamespace(loss_fn=jmlp.loss_fn),
                             j_optim.sgd(1.0), J_PARAMS, shards=shards)
        assert j_restore(srv, d, scenario=sc) == CUT
        for a, b in zip(_leaves(srv.params),
                        jax.tree.leaves(params_to_numpy(port.params))):
            assert np.array_equal(a, b)
        for jc, tc in zip(srv.cohorts, port.server.cohorts):
            assert isinstance(jc, JT.EdgeCohort)
            for a, b in zip(_leaves(jc.ef_buffer), jax.tree.leaves(
                    params_to_numpy(tc.ef_buffer))):
                assert a.shape == (4, tc.cap) + a.shape[2:]
                assert np.array_equal(a, b)
        for _ in range(ROUNDS - CUT):
            srv.round()
        for a, b in zip(_leaves(srv.params), _leaves(full.params)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    finally:
        shutil.rmtree(d, ignore_errors=True)
