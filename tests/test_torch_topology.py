"""Hierarchical fleets in the port (``repro_torch.core.topology``): the
twins of the reference's ``tests/test_topology.py`` on the CPU (the spec,
the edge grids, the split-edge invariances the hub combine rests on, the
scenario threading and refusals, scan bitwise eager, the census and the
traffic model), plus what the port adds: sharded bitwise unsharded over
a two-block CPU mesh (eager and scan), the mesh's placement and
refusals, and a bitwise kill and resume with fp8 EF rows. No JAX here;
``test_torch_topology_parity.py`` holds the port against the reference.
"""
import json
import types

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

import repro_torch.fl as T
from repro_torch import optim
from repro_torch.configs.paper_mlp import config
from repro_torch.core.aggregation import (finalize, scatter_accumulate,
                                          zeros_like_acc)
from repro_torch.core.compression import (DEVICE_TIERS, compress_params,
                                          slice_tree, submodel_spec)
from repro_torch.core.compression.quantization import fake_quant_ste
from repro_torch.core.topology import EdgeBlocks, EdgeMesh
from repro_torch.models import mlp

torch.set_num_threads(1)

TIERS = ("hub", "high", "mid", "low")
MODEL = types.SimpleNamespace(loss_fn=mlp.loss_fn)
PARAMS = mlp.init(torch.Generator().manual_seed(3), config())
CPU = torch.device("cpu")


def _bit_identical(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ------------------------------------------------------------- the spec

class TestFleetTopology:
    def test_contiguous_shapes(self):
        t = T.FleetTopology.contiguous(10, 3)
        assert t.n_edges == 3 and t.n_clients == 10
        assert t.edges == ((0, 1, 2, 3), (4, 5, 6), (7, 8, 9))

    def test_round_robin_spreads_plans(self):
        t = T.FleetTopology.round_robin(8, 4)
        assert t.edges == ((0, 4), (1, 5), (2, 6), (3, 7))

    def test_validation(self):
        with pytest.raises(ValueError, match="at least one edge"):
            T.FleetTopology(())
        with pytest.raises(ValueError, match="empty"):
            T.FleetTopology(((0, 1), ()))
        with pytest.raises(ValueError, match="two edge groups"):
            T.FleetTopology(((0, 1), (1, 2)))
        with pytest.raises(ValueError, match="negative"):
            T.FleetTopology(((-1, 0),))
        T.FleetTopology(((2, 0), (1,))).validate(3)
        with pytest.raises(ValueError, match="fleet has"):
            T.FleetTopology(((0, 1),)).validate(3)
        with pytest.raises(ValueError, match="fleet has"):
            T.FleetTopology(((0, 5),)).validate(2)

    def test_json_round_trip_and_hash(self):
        t = T.FleetTopology.contiguous(10, 3)
        t2 = T.FleetTopology.from_dict(json.loads(json.dumps(t.to_dict())))
        assert t2 == t and hash(t2) == hash(t)

    def test_edge_of(self):
        t = T.FleetTopology(((3, 1), (0, 2)))
        assert t.edge_of() == {3: 0, 1: 0, 0: 1, 2: 1}


# ----------------------------------------------------------- edge grids

def _fleet(n=16, edges=4, **kw):
    return T.FleetSpec.cycling(TIERS, n, samples_per_client=8,
                               edges=edges, **kw)


class TestEdgeGrids:
    def test_grid_shapes_and_values(self):
        spec = _fleet(16, 4)
        clients = spec.build_clients()
        cohorts = T.build_edge_cohorts(clients, spec.topology, CPU)
        assert len(cohorts) == len(TIERS)
        flat = {c.id: c for c in clients}
        for cohort in cohorts:
            assert isinstance(cohort, T.EdgeCohort)
            assert cohort.n_edges == 4
            assert tuple(cohort.data["x"].shape[:2]) == (4, cohort.cap)
            for i, cid in enumerate(cohort.client_ids):
                e, r = cohort.edge_index[i], cohort.row_index[i]
                for k, grid in cohort.data.items():
                    assert torch.equal(grid[e, r], flat[cid].data[k])

    def test_padding_rows_are_zero(self):
        spec = T.FleetSpec.cycling(TIERS, 10, samples_per_client=4, edges=3)
        cohorts = T.build_edge_cohorts(spec.build_clients(), spec.topology,
                                       CPU)
        for cohort in cohorts:
            used = np.zeros((cohort.n_edges, cohort.cap), bool)
            used[cohort.edge_index, cohort.row_index] = True
            for grid in cohort.data.values():
                assert not grid[torch.from_numpy(~used)].any()

    def test_flat_metadata_preserved(self):
        spec = _fleet(16, 4)
        clients = spec.build_clients()
        grids = T.build_cohorts(clients, CPU, spec.topology)
        flats = T.build_cohorts(clients, CPU)
        for g, f in zip(grids, flats):
            assert g.plan == f.plan
            assert g.client_ids == f.client_ids
            assert g.profile_names == f.profile_names

    def test_scatter_part_hits_cells_only(self):
        spec = _fleet(16, 4)
        cohort = T.build_edge_cohorts(spec.build_clients(), spec.topology,
                                      CPU)[0]
        part = np.zeros(cohort.size, bool)
        part[::2] = True
        grid = T.scatter_part(cohort, part)
        assert grid.shape == (cohort.n_edges, cohort.cap)
        assert grid.dtype == np.float32
        assert grid.sum() == part.sum()
        for i in range(cohort.size):
            assert grid[cohort.edge_index[i], cohort.row_index[i]] == part[i]


# --------------------------- split-edge aggregation invariance

def _contribs(seed, counts, struct, quantize=False):
    """Per-edge contributions ``(update_sum, count)`` for one plan: what
    each edge gateway forwards to the hub."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for c in counts:
        g = {k: 4.0 * torch.randn(p.shape, generator=gen)
             for k, p in struct.items()}
        if quantize:
            g = {k: fake_quant_ste(x, 4, 3) for k, x in g.items()}
        out.append((g, float(c)))
    return out


def _partials_vs_chain(struct, contribs, masks, spec, weight, dense_den):
    """Each edge's partial accumulator (from exact zeros) added in fixed
    edge order is bitwise the hub's chain over the same edges: the first
    add into +0 is the contribution itself, so the combine's adds are
    the chain's."""
    chain = zeros_like_acc(struct, dense_den=dense_den)
    for g, count in contribs:
        chain = scatter_accumulate(chain, g, masks, spec, weight, count)
    combined = None
    for g, count in contribs:
        part = scatter_accumulate(zeros_like_acc(struct, dense_den=dense_den),
                                  g, masks, spec, weight, count)
        combined = part if combined is None else tuple(
            {k: a[k] + b[k] for k in a} for a, b in zip(combined, part))
    assert _bit_identical(chain, combined)
    assert _bit_identical(finalize(chain), finalize(combined))


SHARD_COUNTS = st.lists(st.integers(0, 7), min_size=1, max_size=4)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**31 - 1), SHARD_COUNTS)
def test_shard_partials_masked(seed, counts):
    plan = DEVICE_TIERS["mid"]
    _, masks = compress_params(PARAMS, plan)
    _partials_vs_chain(PARAMS, _contribs(seed, counts, PARAMS), masks, None,
                       plan.weight, dense_den=False)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**31 - 1), SHARD_COUNTS)
def test_shard_partials_structured_width_sliced(seed, counts):
    plan = DEVICE_TIERS["low"].as_width_sliced()
    spec = submodel_spec(PARAMS, plan.width)
    local = slice_tree(PARAMS, spec)
    _, masks = compress_params(local, plan.inner())
    _partials_vs_chain(PARAMS, _contribs(seed, counts, local), masks, spec,
                       plan.weight, dense_den=True)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**31 - 1), SHARD_COUNTS)
def test_shard_partials_quantized_uploads(seed, counts):
    plan = DEVICE_TIERS["mid"]
    _, masks = compress_params(PARAMS, plan)
    _partials_vs_chain(PARAMS, _contribs(seed, counts, PARAMS, True), masks,
                       None, plan.weight, dense_den=False)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**31 - 1), SHARD_COUNTS)
def test_empty_shards_are_exact_identity(seed, counts):
    """Exact-zero edges (empty edges, padding rows) between the others
    leave the hub's chain bitwise as it was: the +0.0 property that lets
    every grid span all E edges."""
    plan = DEVICE_TIERS["mid"]
    _, masks = compress_params(PARAMS, plan)
    contribs = _contribs(seed, counts, PARAMS)
    zero = ({k: torch.zeros_like(p) for k, p in PARAMS.items()}, 0.0)
    withz = [zero]
    for c in contribs:
        withz += [c, zero]
    a = zeros_like_acc(PARAMS)
    for g, count in contribs:
        a = scatter_accumulate(a, g, masks, None, plan.weight, count)
    b = zeros_like_acc(PARAMS)
    for g, count in withz:
        b = scatter_accumulate(b, g, masks, None, plan.weight, count)
    assert _bit_identical(a, b)


# ------------------------------------------- scenario / server threading

SCENARIOS = {
    "sync_wait": T.FLScenario(
        fleet=_fleet(16, 4),
        participation=T.ParticipationPolicy(fraction=0.5, seed=11)),
    "sync_drop": T.FLScenario(fleet=_fleet(16, 4),
                              timing=T.SyncDrop(deadline=0.004)),
    "fedavg": T.FLScenario(
        fleet=_fleet(8, 4),
        local=T.LocalTraining(mode="fedavg", local_steps=3, local_lr=0.5)),
    "quant_ef": T.FLScenario(
        fleet=_fleet(8, 4),
        upload=T.UploadPolicy(quant="fp8_e4m3", error_feedback=True),
        participation=T.ParticipationPolicy(fraction=0.6, seed=5)),
    "width": T.FLScenario(fleet=_fleet(8, 4),
                          local=T.LocalTraining(submodel="width")),
}


def _server(name):
    return T.build_server(SCENARIOS[name], MODEL, optim.sgd(1.0), PARAMS,
                          device="cpu")


def _run(name, engine="eager", rounds=5, **kw):
    return T.simulate(SCENARIOS[name], rounds, params=PARAMS, engine=engine,
                      device="cpu", **kw)


class TestScenarioThreading:
    def test_fleet_spec_round_trip(self):
        spec = _fleet(16, 4)
        d = json.loads(json.dumps(spec.to_dict()))
        assert d["topology"] == {"edges": [[0, 1, 2, 3], [4, 5, 6, 7],
                                           [8, 9, 10, 11], [12, 13, 14, 15]]}
        spec2 = T.FleetSpec.from_dict(d)
        assert spec2 == spec and hash(spec2) == hash(spec)
        sc = SCENARIOS["quant_ef"]
        assert T.FLScenario.from_dict(json.loads(json.dumps(
            sc.to_dict()))) == sc

    def test_topology_must_cover_fleet(self):
        with pytest.raises(ValueError, match="fleet has"):
            T.FleetSpec(tiers=TIERS * 2, n_samples=64,
                        topology=T.FleetTopology.contiguous(16, 4))

    def test_rejected_combinations(self):
        with pytest.raises(ValueError, match="per-client"):
            T.FLScenario(fleet=_fleet(16, 4), runtime="client")
        with pytest.raises(ValueError, match="sync-only"):
            T.FLScenario(fleet=_fleet(16, 4),
                         timing=T.AsyncBuffered(buffer_size=4))
        with pytest.raises(ValueError, match="hierarchical"):
            T.FLScenario(fleet=_fleet(16, 4),
                         faults=T.FaultPolicy(corrupt_rate=0.1))
        srv = _server("sync_wait")
        with pytest.raises(ValueError, match="hierarchical"):
            T.CohortFLServer(model=MODEL, optimizer=optim.sgd(1.0),
                             cohorts=srv.cohorts, params=PARAMS,
                             topology=srv.topology,
                             faults=T.FaultPolicy(clip_norm=1.0))

    def test_build_server_makes_edge_grids(self):
        srv = _server("sync_wait")
        assert all(isinstance(c, T.EdgeCohort) for c in srv.cohorts)
        assert srv.topology == SCENARIOS["sync_wait"].fleet.topology
        assert srv.mesh is None

    def test_engine_rejects_pallas(self):
        with pytest.raises(ValueError, match="pallas"):
            T.ScanEngine(_server("sync_wait"), agg="pallas")
        with pytest.raises(ValueError, match="pallas"):
            _run("sync_wait", "scan_pallas", 1)

    def test_shard_fleet_rejects_flat_server(self):
        sc = T.FLScenario(fleet=T.FleetSpec.cycling(TIERS, 8,
                                                    samples_per_client=8))
        srv = T.build_server(sc, MODEL, optim.sgd(1.0), PARAMS, device="cpu")
        with pytest.raises(ValueError, match="topology server"):
            T.shard_fleet(srv)


# ------------------------------------------------ trajectory identities

def _records(res) -> list:
    return [(r.loss, r.n_participants, r.n_dropped, r.round_wall_time,
             r.total_upload_bytes) for r in res.records]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scan_engine_bit_identical_to_eager(name):
    """The engine's grid rounds reproduce the eager grid rounds' params,
    optimizer state and records bit for bit; its wall-clock and bytes
    are host float64 with the eager expressions, so they are exactly
    equal too."""
    eager = _run(name)
    scan = _run(name, "scan", chunk_rounds=2)
    assert _bit_identical(eager.params, scan.params)
    assert _bit_identical(eager.opt_state, scan.opt_state)
    assert _records(eager) == _records(scan)
    assert all(r.loss is not None and np.isfinite(r.loss)
               for r in eager.records)


@pytest.mark.parametrize("name", ["sync_wait", "fedavg", "quant_ef",
                                  "width"])
@pytest.mark.parametrize("engine", ["eager", "scan"])
def test_sharded_bit_identical_to_unsharded(name, engine):
    """Placement only: the same rounds over a two-block mesh reproduce
    the unsharded run bit for bit, eager and scan (each edge computed in
    shapes that do not depend on its block)."""
    mesh = T.make_edge_mesh(4, devices=[CPU, CPU])
    assert mesh.size == 2
    un = _run(name, engine, 4)
    sh = _run(name, engine, 4, mesh=mesh)
    assert sh.server.mesh is mesh
    assert _bit_identical(un.params, sh.params)
    assert _bit_identical(un.opt_state, sh.opt_state)
    assert _records(un) == _records(sh)


def test_four_blocks_and_default_mesh_bitwise():
    """One edge per block, and ``mesh=True`` (the run's device: here the
    one-block CPU mesh), both bitwise the unsharded run."""
    un = _run("quant_ef", "scan", 4)
    four = _run("quant_ef", "scan", 4,
                mesh=T.make_edge_mesh(4, devices=[CPU] * 4))
    default = _run("quant_ef", "eager", 4, mesh=True)
    assert default.server.mesh.devices == (CPU,)
    for res in (four, default):
        assert _bit_identical(un.params, res.params)
        assert _records(un) == _records(res)


def test_shard_fleet_places_edge_axis():
    """Every grid leaf (and EF row) in the mesh's blocks along the edge
    axis, params and optimizer state on the hub, the mesh remembered."""
    srv = _server("quant_ef")
    mesh = T.make_edge_mesh(4, devices=[CPU, CPU])
    T.ScanEngine(srv).run(1)                    # makes the EF grids
    assert all(c.ef_buffer is not None for c in srv.cohorts)
    assert T.shard_fleet(srv, mesh) is srv and srv.mesh is mesh
    for c in srv.cohorts:
        for leaf in list(c.data.values()) + list(c.ef_buffer.values()):
            assert isinstance(leaf, EdgeBlocks)
            assert [b.shape[0] for b in leaf.blocks] == [2, 2]
            assert tuple(leaf.shape[:2]) == (4, c.cap)
    assert all(p.device == mesh.hub for p in srv.params.values())


def test_mesh_refusals(monkeypatch):
    srv = _server("sync_wait")
    with pytest.raises(ValueError, match="do not divide"):
        T.shard_fleet(srv, EdgeMesh((CPU,) * 3))
    assert T.make_edge_mesh(6, devices=[CPU] * 4).size == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        T.make_edge_mesh(4)


@pytest.mark.parametrize("engine", ["eager", "scan"])
@pytest.mark.parametrize("sharded", [False, True])
def test_kill_and_resume_with_edge_ef_is_bitwise(engine, sharded, tmp_path):
    """A topology run with fp8 EF rows, checkpointed every 2 rounds, cut
    at 3 and resumed to 6, ends bitwise the uninterrupted run; the npz
    holds the whole ``(E, cap, ...)`` EF grid (under a mesh too)."""
    sc = SCENARIOS["quant_ef"]
    kw = dict(params=PARAMS, engine=engine, device="cpu",
              mesh=T.make_edge_mesh(4, devices=[CPU, CPU]) if sharded
              else None)
    d = str(tmp_path)
    full = T.simulate(sc, 6, **kw)
    T.simulate(sc, 3, checkpoint_every=2, checkpoint_dir=d, **kw)
    with np.load(f"{d}/state_00000002.npz") as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        shapes = {m["name"]: z[k].shape for k, m in meta.items()}
    cohorts = full.server.cohorts
    for ci, c in enumerate(cohorts):
        assert shapes[f"ef/{ci}/layers/0/w"] == (4, c.cap, 5, 10)
    res = T.simulate(sc, 6, checkpoint_every=2, resume_from=d, **kw)
    assert _bit_identical(full.params, res.params)
    assert full.records == res.records


# --------------------------------------------------- census and traffic

class TestCensusAndTraffic:
    def test_census_edge_groups(self):
        c = T.scenario_census(SCENARIOS["width"])
        assert c["n_edges"] == 4
        assert len(c["edge_groups"]) == 4
        assert sum(g["clients"] for g in c["edge_groups"]) == 8
        for g in c["edge_groups"]:
            assert g["active_params_max"] > 0
            assert g["round_wall_time"] > 0
            assert g["uplink_bytes"] > 0

    def test_cross_shard_bytes_independent_of_client_count(self):
        small = T.scenario_census(T.FLScenario(fleet=_fleet(16, 4)))
        big = T.scenario_census(T.FLScenario(fleet=_fleet(64, 4)))
        assert (small["cross_shard_bytes_per_round"]
                == big["cross_shard_bytes_per_round"])
        more_edges = T.scenario_census(T.FLScenario(fleet=_fleet(64, 8)))
        assert (more_edges["cross_shard_bytes_per_round"]
                == 2 * small["cross_shard_bytes_per_round"])

    def test_cross_shard_bytes_structured_is_smaller(self):
        plans = [DEVICE_TIERS[t] for t in TIERS]
        full = T.cross_shard_bytes(PARAMS, plans, 4)
        sliced = T.cross_shard_bytes(
            PARAMS, [p.as_width_sliced() for p in plans], 4)
        assert sliced < full

    def test_cross_shard_bytes_from_shapes_alone(self):
        """Meta tensors or plain shapes give the same bytes as real
        params: the census allocates nothing for it."""
        plans = [DEVICE_TIERS[t].as_width_sliced() for t in TIERS]
        meta = {k: torch.empty(p.shape, device="meta")
                for k, p in PARAMS.items()}
        shapes = {k: tuple(p.shape) for k, p in PARAMS.items()}
        want = T.cross_shard_bytes(PARAMS, plans, 8)
        assert T.cross_shard_bytes(meta, plans, 8) == want
        assert T.cross_shard_bytes(shapes, plans, 8) == want
