"""The LM dry run's per-device census (``launch.mesh.census_mesh``,
``models.parallel.Census``, ``launch.specs.rank_traced``): a record
(train, prefill, decode) traces one rank's step of the sharded program
at the production meshes' size on fake tensors, with no process group,
and records the reference's ``collectives`` keys and that rank's temp
bytes.

At smoke widths, no JAX: every arch's train, prefill and decode record
on both production meshes (16 x 16 and 2 x 16 x 16), its keys, argument
and output bytes
against the rank's own blocks and outputs, and no ``torch.distributed``
call on the way; the rank's arguments plus temp against the global
trace's on (2, 2); a collective inside a scan counted times its length;
the census mesh's coordinates and the data axes' row-major slot. The
census against real gloo ranks is held in the files that run those
ranks (``test_torch_fsdp*.py``, ``test_torch_parallel*.py``)."""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, ShapeConfig, get_smoke_config
from repro_torch.launch import dryrun, specs
from repro_torch.launch.analysis import nbytes, trace_step
from repro_torch.launch.mesh import Mesh, census_mesh, make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import parallel
from repro_torch.models.sharding import blocks, shard_bytes

# 32 rows a tier: they split over the multi-pod mesh's 32 data ranks
SHAPE = ShapeConfig("t", 16, 128, "train")
KEYS = {"bytes_by_op", "count_by_op", "total_bytes"}

torch.set_num_threads(1)


def _abstract(dp: int, mp: int) -> Mesh:
    devices = np.empty((dp, mp), dtype=object)
    devices.fill(torch.device("meta"))
    return Mesh(devices, ("data", "model"))


def _no_process_group(monkeypatch) -> None:
    """Every ``torch.distributed`` call a rank's step could make raises."""
    def refuse(*a, **k):
        raise AssertionError("torch.distributed called under the census")
    for name in ("all_reduce", "all_gather", "reduce_scatter_tensor",
                 "get_rank", "get_world_size", "barrier"):
        monkeypatch.setattr(dist, name, refuse)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_record_is_one_ranks_trace(arch, multi_pod, tmp_path,
                                         monkeypatch):
    """Each arch's smoke config: an ``ok`` train record on the production
    mesh, its ``collectives`` the reference's keys (per-op counts and
    bytes, their total), its temp per device; the rank's outputs are the
    record's output bytes, its blocks plus its batch rows the argument
    bytes; no ``torch.distributed`` call is made."""
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    monkeypatch.setitem(dryrun.SHAPES, SHAPE.name, SHAPE)
    _no_process_group(monkeypatch)
    rec = dryrun.run_one(arch, SHAPE.name, multi_pod, str(tmp_path))
    assert rec["status"] == "ok", rec.get("traceback")
    coll = rec["collectives"]
    assert set(coll) == KEYS
    assert set(coll["count_by_op"]) == set(coll["bytes_by_op"]) \
        >= {"all-gather", "all-reduce", "reduce-scatter"}
    assert coll["total_bytes"] == sum(coll["bytes_by_op"].values())
    mem = rec["memory"]
    assert mem["temp_scope"] == "device" and mem["temp_size_in_bytes"] > 0
    assert rec["rank_trace_s"] >= 0 and rec["trace_s"] >= 0
    on_disk = json.loads((tmp_path / f"{arch}__t__{rec['mesh']}.json")
                         .read_text())
    assert on_disk["collectives"] == coll

    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = get_smoke_config(arch)
    _, out, _ = specs.rank_traced(cfg, SHAPE, mesh)
    assert nbytes(out) == mem["output_size_in_bytes"]
    census = census_mesh(mesh)
    _, (state, batch), (state_sh, batch_sh), _ = specs.train_setup(
        cfg, SHAPE, census)
    with specs.fake_mode():
        own = blocks(state, state_sh)
    assert nbytes(own) + shard_bytes(batch, batch_sh) \
        == mem["argument_size_in_bytes"]


# a prompt of 64 at 32 rows: the rows split over the multi-pod mesh's 32
# data ranks, the cache's 64 slots over the 16 model ranks
SERVE_SHAPES = {"prefill": ShapeConfig("p", 64, 32, "prefill"),
                "decode": ShapeConfig("d", 64, 32, "decode")}


@pytest.mark.parametrize("mode", list(SERVE_SHAPES))
@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_record_is_one_ranks_trace(arch, multi_pod, mode, tmp_path,
                                         monkeypatch):
    """Each arch's smoke prefill and decode records on both production
    meshes: ``ok``, ``collectives`` with the reference's keys and the
    temp per device from rank 0's trace (``rank_trace_s`` beside
    ``trace_s``), with no ``torch.distributed`` call; the rank's outputs
    are the record's output bytes: the logits whole and its block of the
    cache as ``cache_spec_tree`` places it."""
    shape = SERVE_SHAPES[mode]
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    monkeypatch.setitem(dryrun.SHAPES, shape.name, shape)
    _no_process_group(monkeypatch)
    rec = dryrun.run_one(arch, shape.name, multi_pod, str(tmp_path))
    assert rec["status"] == "ok", rec.get("traceback")
    coll = rec["collectives"]
    assert set(coll) == KEYS
    assert set(coll["count_by_op"]) == set(coll["bytes_by_op"])
    assert coll["total_bytes"] == sum(coll["bytes_by_op"].values()) > 0
    mem = rec["memory"]
    assert mem["temp_scope"] == "device" and mem["temp_size_in_bytes"] > 0
    assert rec["rank_trace_s"] >= 0 and rec["trace_s"] >= 0
    _, out, _ = specs.rank_traced(get_smoke_config(arch), shape,
                                  make_production_mesh(multi_pod=multi_pod))
    assert nbytes(out) == mem["output_size_in_bytes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_holds_no_more_than_the_whole_step(arch):
    """On (2, 2) a rank's arguments plus its temp peak are no larger than
    the global trace's (the whole state and batch plus its peak)."""
    cfg = get_smoke_config(arch)
    mesh = _abstract(2, 2)
    rec = dryrun.dry_run_step(cfg, SHAPE, mesh)
    step, args, _, _ = specs.train_setup(cfg, SHAPE, mesh)
    whole, _, _ = specs.traced(cfg, SHAPE, mesh, step, args)
    mem = rec["memory"]
    assert 0 < mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] \
        <= nbytes(args) + whole["temp_bytes"]
    assert rec["collectives"]["total_bytes"] > 0


@pytest.mark.parametrize("repeats", [True, False])
def test_scan_counts_its_body_times_its_length(repeats):
    """A toy cell that all-reduces its carry over "model" on a census
    mesh: N steps count N all-reduces of the carry's bytes, forward and
    backward (``copy_to_model``'s backward sums the gradient), whether
    the scan is traced by its multiplier or step by step."""
    n, width = 7, 5
    census = census_mesh(_abstract(1, 2))

    def cell(consts, carry, x):
        (h,) = carry
        h = parallel.all_reduce(h, "model") + parallel.copy_to_model(
            x[0] * consts[0])
        return (h,), h

    def step(w, h0, xs):
        w = w.detach().requires_grad_()
        _, ys = L.scan(cell, (h0,), (xs,), (w,))
        (g,) = torch.autograd.grad(ys.sum(), [w])
        return g

    with parallel.using(census):
        counts, _ = trace_step(step, torch.ones(width), torch.zeros(3, width),
                               torch.ones(3, n, width), repeats_scans=repeats)
    coll = counts["collectives"]
    assert counts["temp_exact"] is not repeats
    assert coll["count_by_op"] == {"all-reduce": 2 * n}
    assert coll["bytes_by_op"] == {"all-reduce": 2 * n * 3 * width * 4}


def test_census_mesh_answers_for_its_rank(monkeypatch):
    """A census mesh's coordinates, sizes and data slot come from its
    stated rank, with no process group; its collectives send nothing and
    return their results' shapes."""
    _no_process_group(monkeypatch)
    big = census_mesh(make_production_mesh(multi_pod=True), rank=300)
    assert big.is_distributed and big.is_census
    assert big.coords() == {"pod": 1, "data": 2, "model": 12}
    with parallel.using(big):
        assert parallel.size(parallel.DATA) == 32
        assert parallel.rank(parallel.DATA) == 18
        assert parallel.rank("model") == 12
        x = torch.ones((4, 3), dtype=torch.bfloat16)
        with parallel.counting() as c:
            assert parallel.all_gather(x, parallel.DATA, 0).shape == (128, 3)
            assert parallel.reduce_scatter(x.repeat(4, 1), "model",
                                           0).shape == (1, 3)
            assert parallel.sum_over(x, "model").dtype == torch.bfloat16
    # the gather over "data" (16 blocks) then over "pod" (2 of those); the
    # bf16 reduce-scatter and sum over 16 ranks move f32
    assert c.record() == {
        "bytes_by_op": {"all-gather": 16 * 24 + 32 * 24, "all-reduce": 48,
                        "reduce-scatter": 12},
        "count_by_op": {"all-gather": 2, "all-reduce": 1,
                        "reduce-scatter": 1},
        "total_bytes": 16 * 24 + 32 * 24 + 48 + 12}
    assert census_mesh(_abstract(2, 2)).coords(3) == {"data": 1, "model": 1}
