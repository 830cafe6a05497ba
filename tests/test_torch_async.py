"""The port's async runtime against the reference: its own copy of the
virtual-clock scheduler (draw for draw), ``AsyncFLServer`` over six
windows from the same params and shards, the staleness discount's
arithmetic, ``scenario_census`` and the scenario JSON across both
packages. Plus the port's ``WindowScanEngine`` against its own eager
windows: bitwise under SGD and momentum, 1e-6 under Adam, interleaved."""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_mlp import config
from repro.core import aggregation as JA
from repro.core import scenario as J
from repro.core import schedule as JS
from repro.models import mlp as jmlp
import repro_torch.fl as T
from repro_torch import optim
from repro_torch.core import aggregation as TA
from repro_torch.core import schedule as TS
from repro_torch.interop import (params_from_numpy, params_to_numpy,
                                 shards_from_numpy)
from repro_torch.models import mlp as tmlp

torch.set_num_threads(1)


# ----------------------------------------------------------- scheduler

SCHEDULES = [
    # (times, buffer_size, seed, jitter, retry)
    ([0.3, 1.0, 0.7, 2.5, 0.3], 2, 0, 0.0, None),
    ([0.01 * (1 + i % 7) for i in range(23)], 5, 11, 0.5, None),
    ([1.0, 1.0, 1.0, 1.0], 4, 3, 0.0, None),              # ties, full buffer
    ([0.2, 0.9, 0.4], 1, 9, 0.1, (0.3, 0.05, 3, 4)),
    ([0.5] + [0.05] * 9, 3, 5, 0.2, (0.5, 0.01, 2, 0)),
]


def _sched(mod, times, k, seed, jitter, retry):
    r = None if retry is None else mod.RetrySpec(*retry)
    return mod.VirtualClockScheduler(times, k, seed=seed, jitter=jitter,
                                     retry=r)


@pytest.mark.parametrize("case", range(len(SCHEDULES)))
def test_scheduler_and_materializer_match_reference(case):
    """Heap traces, materialized plans (every array) and the census are
    exactly the reference's, after a few windows already popped."""
    args = SCHEDULES[case]
    js, ts = _sched(JS, *args), _sched(TS, *args)
    assert ts.trace(3) == [TS.Window(w.t, w.version, tuple(
        TS.Upload(*(getattr(u, f) for f in ("t", "seq", "client", "version")))
        for u in w.uploads)) for w in js.trace(3)]
    jp, tp = JS.materialize_windows(js, 17), TS.materialize_windows(ts, 17)
    for f in ("t", "client", "upload_t", "upload_seq", "upload_version",
              "n_versions_live", "end_version", "staleness"):
        a, b = getattr(jp, f), getattr(tp, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (tp.buffer_size, tp.version0, tp.max_version_lag) == \
        (jp.buffer_size, jp.version0, jp.max_version_lag)
    times, k, seed, jitter, _ = args
    assert TS.schedule_census(times, k, 9, seed, jitter) == \
        JS.schedule_census(times, k, 9, seed, jitter)


def test_dispatch_time_and_retry_delay_match_reference():
    for seed, c, d in [(0, 0, 0), (7, 3, 11), (2**31 - 1, 255, 1000)]:
        for jitter in (0.0, 0.2, 1.5):
            assert TS.dispatch_time(0.37, jitter, seed, c, d) == \
                JS.dispatch_time(0.37, jitter, seed, c, d)
        for spec in [(0.5, 0.01, 4, seed), (0.0, 1.0, 3, seed),
                     (0.9, 0.2, 0, seed), (1.0, 0.1, 5, seed)]:
            assert TS.RetrySpec(*spec).delay(c, d) == \
                JS.RetrySpec(*spec).delay(c, d)


# ------------------------------------------------------ async runtime

def _async_spec(mod, tiers, n):
    return mod.FleetSpec.cycling(tiers, n, samples_per_client=8)


def _scenarios(mod):
    jit = mod.AsyncBuffered(buffer_size=2, staleness_exp=0.5, time_jitter=0.1)
    return {
        "masked_jitter": mod.FLScenario(
            fleet=_async_spec(mod, ["hub", "mid", "low"], 6), timing=jit),
        "width": mod.FLScenario(
            fleet=_async_spec(mod, ["hub", "embedded"], 6),
            local=mod.LocalTraining(submodel="width"), timing=jit),
        "fedavg": mod.FLScenario(
            fleet=_async_spec(mod, ["hub", "mid"], 6),
            local=mod.LocalTraining(mode="fedavg", local_steps=2),
            timing=jit),
        "fp8_ef": mod.FLScenario(
            fleet=_async_spec(mod, ["hub", "mid"], 6),
            upload=mod.UploadPolicy(quant="fp8_e4m3", error_feedback=True),
            timing=mod.AsyncBuffered(buffer_size=3, staleness_exp=0.5)),
    }


@pytest.mark.parametrize("name", ["masked_jitter", "width", "fedavg",
                                  "fp8_ef"])
def test_async_server_matches_reference(name, windows=6):
    """Losses to rtol 1e-5 and params to atol 1e-5 (PR 11's bar); the
    virtual clock, stalenesses, live versions and bytes exactly; and the
    port's ``scan`` (WindowScanEngine) bitwise its eager run."""
    sc = _scenarios(J)[name]
    port_sc = T.FLScenario.from_dict(json.loads(json.dumps(sc.to_dict())))
    assert port_sc == _scenarios(T)[name]
    params = jmlp.init(jax.random.PRNGKey(0), config())
    shards = [jax.tree.map(np.asarray, c.data)
              for c in sc.fleet.build_clients()]
    ref = J.simulate(sc, windows, params=params, shards=shards)
    kw = dict(device="cpu", shards=shards_from_numpy(shards),
              params=params_from_numpy(jax.tree.map(np.asarray, params)))
    out = T.simulate(port_sc, windows, **kw)
    scan = T.simulate(port_sc, windows, engine="scan_pallas", **kw)
    assert scan.agg_backend == ref.agg_backend == "sequential"
    np.testing.assert_allclose(out.losses, ref.losses, rtol=1e-5)
    fields = ("step", "t", "n_updates", "staleness_mean", "staleness_max",
              "n_versions_live", "total_upload_bytes")
    for a, b in zip(ref.records, out.records):
        assert [getattr(b, f) for f in fields] == [getattr(a, f)
                                                   for f in fields]
    assert any(r.staleness_max > 0 for r in out.records)
    assert out.sim_time == ref.sim_time == ref.final.t
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, ref.params)),
                    jax.tree.leaves(params_to_numpy(out.params))):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    assert scan.records == out.records
    assert all(torch.equal(scan.params[k], out.params[k]) for k in out.params)


MODEL = types.SimpleNamespace(loss_fn=tmlp.loss_fn)


def _port_pair(optimizer):
    sc = _scenarios(T)["masked_jitter"]
    params = tmlp.init(torch.Generator().manual_seed(0), config())
    return (T.build_server(sc, MODEL, optimizer, params, device="cpu"),
            T.build_server(sc, MODEL, optimizer, params, device="cpu"))


def _state_leaves(srv):
    return list(srv.params.values()) + [
        t for t in jax.tree.leaves(srv.opt_state) if torch.is_tensor(t)]


@pytest.mark.parametrize("opt,exact", [("sgd", True), ("momentum", True),
                                       ("adam", False)])
def test_window_engine_matches_eager_steps(opt, exact):
    """Bitwise under SGD and momentum, params and optimizer state; 1e-6
    under Adam (the reference's claim). Records, version store and
    refcounts equal; a chunk size that does not divide the windows."""
    optimizer = {"sgd": optim.sgd(1.0), "momentum": optim.momentum(0.5),
                 "adam": optim.adam(0.05)}[opt]
    srv_e, srv_s = _port_pair(optimizer)
    for _ in range(7):
        srv_e.step()
    recs = T.WindowScanEngine(srv_s, chunk_windows=3).run(7)
    for a, b in zip(_state_leaves(srv_e), _state_leaves(srv_s)):
        if exact:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert recs == srv_e.history == srv_s.history
    assert srv_e.version == srv_s.version
    assert sorted(srv_e._versions) == sorted(srv_s._versions)
    assert srv_e._refs == srv_s._refs


def test_window_engine_interleaves_with_eager_steps():
    """Eager windows, engine windows, eager again: one trajectory,
    bitwise all-eager, with the scheduler and version store in step."""
    srv_e, srv_s = _port_pair(optim.momentum(0.5))
    for _ in range(6):
        srv_e.step()
    eng = T.WindowScanEngine(srv_s)
    srv_s.step()
    eng.run(2)
    srv_s.step()
    T.simulate_rounds(srv_s, 2)
    for a, b in zip(_state_leaves(srv_e), _state_leaves(srv_s)):
        assert torch.equal(a, b)
    assert srv_e.history == srv_s.history
    assert eng.chunks_run == 1 and eng.windows_run == 2


def test_full_buffer_no_discount_matches_sync_wait():
    """buffer_size == n_clients and no discount: every window is a
    synchronous round on the live version, to 1e-6 in params."""
    fleet = T.FleetSpec.cycling(["hub", "high", "mid", "low"], 8)
    params = tmlp.init(torch.Generator().manual_seed(1), config())
    sync = T.simulate(T.FLScenario(fleet=fleet), 3, params=params,
                      device="cpu")
    asy = T.simulate(T.FLScenario(fleet=fleet, timing=T.AsyncBuffered(
        buffer_size=8, staleness_exp=0.0)), 3, params=params, device="cpu",
        engine="scan")
    t_cum = 0.0
    for rs, ra in zip(sync.records, asy.records):
        t_cum += rs.round_wall_time
        assert ra.loss == pytest.approx(rs.loss, abs=1e-6)
        assert ra.staleness_max == 0
        assert ra.t == pytest.approx(t_cum, rel=1e-9)
    assert max((sync.params[k] - asy.params[k]).abs().max().item()
               for k in params) < 1e-6


# ---------------------------------------------------- staleness weight

@pytest.mark.parametrize("staleness", [None, 0, 1, 3, 10])
def test_staleness_weight_is_bitwise_reference_accumulate(staleness):
    """num += m * ((w * s) * g), den += m * (w * n): the numerator alone
    carries the discount, bit for bit the reference's f32 chain, in
    accumulate_cohort and in scatter_accumulate's sliced blocks."""
    rng = np.random.default_rng(4)
    g = rng.standard_normal((6, 7)).astype(np.float32)
    m = (rng.random((6, 7)) < 0.6).astype(np.float32)
    acc0 = rng.standard_normal((6, 7)).astype(np.float32)
    w, count = 0.7, 5.0
    disc = None if staleness is None else (1.0 + staleness) ** -0.5
    j = JA.finalize(JA.accumulate_cohort(
        ({"a": jnp.asarray(acc0)}, {"a": jnp.abs(jnp.asarray(acc0))}),
        {"a": jnp.asarray(g)}, {"a": jnp.asarray(m)}, jnp.float32(w),
        jnp.float32(count),
        staleness_weight=None if disc is None else jnp.float32(disc)))["a"]
    t = TA.finalize(TA.accumulate_cohort(
        ({"a": torch.from_numpy(acc0)},
         {"a": torch.from_numpy(np.abs(acc0))}),
        {"a": torch.from_numpy(g)}, {"a": torch.from_numpy(m)}, w, count,
        staleness_weight=disc))["a"]
    assert np.array_equal(t.numpy(), np.asarray(j))
    if disc is not None:
        plain = TA.accumulate_cohort(
            TA.zeros_like_acc({"a": torch.zeros(6, 7)}),
            {"a": torch.from_numpy(g)}, {"a": torch.ones(6, 7)}, 1.0, 1.0)
        damped = TA.accumulate_cohort(
            TA.zeros_like_acc({"a": torch.zeros(6, 7)}),
            {"a": torch.from_numpy(g)}, {"a": torch.ones(6, 7)}, 1.0, 1.0,
            staleness_weight=disc)
        assert torch.equal(damped[1]["a"], plain[1]["a"])
        torch.testing.assert_close(TA.finalize(damped)["a"],
                                   TA.f32(disc) * TA.finalize(plain)["a"])


def test_scatter_accumulate_staleness_weight_matches_reference():
    from repro.core.compression import submodel_spec as j_spec
    from repro_torch.core.compression import submodel_spec as t_spec
    jp = jmlp.init(jax.random.PRNGKey(2), config())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    js, ts = j_spec(jp, 0.5), t_spec(tp, 0.5)
    rng = np.random.default_rng(5)
    sub = [rng.standard_normal(ts.local_shape(i)).astype(np.float32)
           for i in range(len(tp))]
    masks = [(rng.random(s.shape) < 0.7).astype(np.float32) for s in sub]
    jt = jax.tree_util.tree_structure(jp)
    j_acc = JA.scatter_accumulate(
        JA.zeros_like_acc(jp, dense_den=True),
        jax.tree_util.tree_unflatten(jt, [jnp.asarray(a) for a in sub]),
        jax.tree_util.tree_unflatten(jt, [jnp.asarray(a) for a in masks]),
        js, jnp.float32(1.0), jnp.float32(3.0),
        staleness_weight=jnp.float32(2.0 ** -0.5))
    t_acc = TA.scatter_accumulate(
        TA.zeros_like_acc(tp, dense_den=True),
        {k: torch.from_numpy(a) for k, a in zip(tp, sub)},
        {k: torch.from_numpy(a) for k, a in zip(tp, masks)},
        ts, 1.0, 3.0, staleness_weight=2.0 ** -0.5)
    for a, b in zip(jax.tree.leaves(JA.finalize(j_acc)),
                    TA.finalize(t_acc).values()):
        assert np.array_equal(b.numpy(), np.asarray(a))


# ----------------------------------------------- census and wire format

CENSUS = {
    "sync_wait": lambda m: m.FLScenario(
        fleet=m.FleetSpec.cycling(("hub", "high", "mid", "low"), 10,
                                  samples_per_client=13)),
    "partial_drop": lambda m: m.FLScenario(
        fleet=m.FleetSpec(tiers=("hub", "low", "embedded"),
                          profiles=("low", "hub", "mid"), n_samples=100),
        participation=m.ParticipationPolicy(fraction=0.5, seed=2),
        timing=m.SyncDrop(deadline=0.004)),
    "async_width_fedavg": lambda m: m.FLScenario(
        fleet=m.FleetSpec.cycling(("hub", "mid", "embedded"), 7),
        local=m.LocalTraining(mode="fedavg", local_steps=3,
                              submodel="width"),
        timing=m.AsyncBuffered(buffer_size=3)),
    "client_dirichlet": lambda m: m.FLScenario(
        fleet=m.FleetSpec(tiers=("high", "low", "low"), n_samples=301,
                          partition="dirichlet", alpha=0.3),
        runtime="client",
        upload=m.UploadPolicy(quant="fp8_e4m3", error_feedback=True)),
}


@pytest.mark.parametrize("name", sorted(CENSUS))
def test_scenario_census_matches_reference(name):
    """The host-only table, key for key and float for float."""
    assert T.scenario_census(CENSUS[name](T)) == \
        J.scenario_census(CENSUS[name](J))


@pytest.mark.parametrize("name", ["client_dirichlet", "async_width_fedavg"])
def test_scenario_json_round_trips_across_packages(name):
    """A ``runtime="client"`` or ``AsyncBuffered`` scenario written by
    either package reads back in the other as the same scenario."""
    j_sc, t_sc = CENSUS[name](J), CENSUS[name](T)
    assert json.loads(json.dumps(j_sc.to_dict())) == \
        json.loads(json.dumps(t_sc.to_dict()))
    assert T.FLScenario.from_dict(json.loads(json.dumps(j_sc.to_dict()))) \
        == t_sc
    assert J.FLScenario.from_dict(json.loads(json.dumps(t_sc.to_dict()))) \
        == j_sc


def test_async_runtime_refuses_faults():
    """The faults the virtual clock cannot model (round-indexed
    availability traces) are refused, as in the reference."""
    sc = _scenarios(T)["masked_jitter"]
    with pytest.raises(ValueError, match="round-indexed"):
        T.AsyncFLServer.from_clients(
            sc.fleet.build_clients(), "cpu", model=MODEL,
            optimizer=optim.sgd(1.0),
            params=tmlp.init(torch.Generator().manual_seed(0), config()),
            buffer_size=2, faults=T.FaultPolicy(period=4, duty_cycle=0.5))
    with pytest.raises(TypeError, match="AsyncFLServer"):
        T.WindowScanEngine(T.build_server(
            T.FLScenario(fleet=sc.fleet), MODEL, optim.sgd(1.0),
            tmlp.init(torch.Generator().manual_seed(0), config()),
            device="cpu"))
