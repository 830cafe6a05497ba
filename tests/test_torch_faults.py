"""The port's fault layer against the reference's: ``FaultPolicy``
(validation, wire format, census block), the four host masks draw for
draw, corruption at ``corrupt_frac=1`` and the finite guard bit for bit,
the norm clip to rtol 1e-6, and runs under faults with error feedback on
every runtime and engine against the reference's eager run (losses rtol
1e-5, params atol 1e-5, fault counts exact). Plus the port against
itself: corruption subsets below 1 (the port's own draw) held to the
defence properties, the inert policy bitwise ``faults=None``, graceful
empty rounds, async ``scan`` bitwise its eager windows and sync
``scan_pallas`` bitwise ``scan`` under availability faults."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, strategies as st
from repro.configs.paper_mlp import config
from repro.core import faults as JF
from repro.core import scenario as J
from repro.models import mlp as jmlp
import repro_torch.fl as T
from repro_torch import optim
from repro_torch.core import aggregation as TA
from repro_torch.core import faults as TF
from repro_torch.interop import (params_from_numpy, params_to_numpy,
                                 shards_from_numpy)
from repro_torch.models import mlp as tmlp

torch.set_num_threads(1)

TIERS = ("hub", "high", "mid", "low", "mid", "low")
ROUNDS = 3
MODEL = type("M", (), {"loss_fn": staticmethod(tmlp.loss_fn)})


# ------------------------------------------------------------- the policy

POLICIES = [
    {},
    {"seed": 3, "period": 5, "duty_cycle": 0.6, "churn_rate": 0.1,
     "dropout_rate": 0.2, "corrupt_rate": 0.05, "corrupt_kind": "bitflip",
     "corrupt_frac": 0.5, "clip_norm": 2.0},
    {"dropout_rate": 0.3, "retry_backoff": 0.5, "max_retries": 0},
    {"period": 4, "duty_cycle": 0.0},
    {"churn_rate": 1.0},
    {"corrupt_rate": 0.1, "corrupt_kind": "zeros"},
    {"corrupt_frac": 0.0},
    {"clip_norm": 0.0},
    {"period": -1},
    {"rejoin_after": 0},
    {"dropout_rate": 1.0},
    {"retry_backoff": -1.0},
    {"max_retries": -1},
    {"corrupt_rate": 1.5},
]


@pytest.mark.parametrize("kw", POLICIES, ids=range(len(POLICIES)))
def test_policy_matches_reference(kw):
    """The same fields are accepted or refused with the same message; an
    accepted policy has the reference's properties and wire dict, and
    reads back from the reference's JSON."""
    try:
        ref = JF.FaultPolicy(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TF.FaultPolicy(**kw)
        assert str(got.value) == str(e)
        return
    pol = TF.FaultPolicy(**kw)
    assert pol.to_dict() == ref.to_dict()
    assert (pol.traces_availability, pol.touches_uploads) == \
        (ref.traces_availability, ref.touches_uploads)
    wire = json.loads(json.dumps(ref.to_dict()))
    assert TF.FaultPolicy.from_dict(wire) == pol
    assert hash(TF.FaultPolicy.from_dict(wire)) == hash(pol)


def test_scenario_faults_round_trip_and_census_match_reference():
    kw = dict(seed=2, period=4, duty_cycle=0.5, churn_rate=0.1,
              dropout_rate=0.1, retry_backoff=0.5, corrupt_rate=0.2)
    j_sc = J.FLScenario(fleet=J.FleetSpec.cycling(TIERS, 6),
                        faults=JF.FaultPolicy(**kw))
    t_sc = T.FLScenario.from_dict(json.loads(json.dumps(j_sc.to_dict())))
    assert t_sc.faults == TF.FaultPolicy(**kw)
    assert t_sc.to_dict() == j_sc.to_dict()
    assert "faults" not in T.FLScenario(fleet=t_sc.fleet).to_dict()
    assert T.scenario_census(t_sc) == J.scenario_census(j_sc)
    with pytest.raises(ValueError, match="round-indexed"):
        T.FLScenario(fleet=t_sc.fleet, timing=T.AsyncBuffered(buffer_size=2),
                     faults=TF.FaultPolicy(period=4, duty_cycle=0.5))


# ------------------------------------------------------------- host masks

MASK_POLICY = dict(seed=7, period=5, duty_cycle=0.6, churn_rate=0.2,
                   rejoin_after=3, dropout_rate=0.3, corrupt_rate=0.4)


@pytest.mark.parametrize("fn", ["availability_mask", "dropout_mask",
                                "corrupt_mask", "corrupt_seq_mask"])
def test_host_masks_match_reference(fn):
    """Every mask is the reference's array, over seeds and rounds (and
    for the async mask, over sequence numbers in any order)."""
    for seed in (0, 7, 2**31 - 1):
        j_pol = JF.FaultPolicy(**{**MASK_POLICY, "seed": seed})
        t_pol = TF.FaultPolicy(**{**MASK_POLICY, "seed": seed})
        if fn == "corrupt_seq_mask":
            seqs = np.random.default_rng(seed).permutation(300)[:64]
            a, b = (JF.corrupt_seq_mask(j_pol, seqs),
                    TF.corrupt_seq_mask(t_pol, seqs))
            assert a.dtype == b.dtype and np.array_equal(a, b)
            continue
        for step in (0, 1, 2, 5, 17, 1000):
            a = getattr(JF, fn)(j_pol, 37, step)
            b = getattr(TF, fn)(t_pol, 37, step)
            assert a.dtype == b.dtype and np.array_equal(a, b)
    off = TF.FaultPolicy()
    assert TF.availability_mask(off, 5, 3).all()
    assert not TF.dropout_mask(off, 5, 3).any()


# ---------------------------------------------------- device-side pipeline

def _updates(seed: int = 0, n: int = 4):
    rng = np.random.default_rng(seed)
    u = {"layers.0.b": rng.normal(size=(n, 4)).astype(np.float32),
         "layers.0.w": (rng.normal(size=(n, 8, 4)) * 3).astype(np.float32)}
    u["layers.0.w"][0, 0, :3] = [np.nan, np.inf, 0.0]
    return u


def _j(u: dict):
    """A port name -> array dict as the reference's tree."""
    return {"layers": [{"b": jnp.asarray(u["layers.0.b"]),
                        "w": jnp.asarray(u["layers.0.w"])}]}


def _j_flat(tree) -> dict:
    return {"layers.0.b": np.asarray(tree["layers"][0]["b"]),
            "layers.0.w": np.asarray(tree["layers"][0]["w"])}


def _same_bits(a: np.ndarray, b) -> bool:
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


@pytest.mark.parametrize("kind", ["nan", "inf", "bitflip"])
def test_inject_and_guard_bitwise_reference(kind):
    """At ``corrupt_frac=1`` the poisoned uploads, the guarded uploads
    and the coverage masks are the reference's bit for bit."""
    u = _updates()
    corrupt = np.asarray([1.0, 0.0, 1.0, 0.0], np.float32)
    uid = np.arange(4) + 40
    j_pol, t_pol = (JF.FaultPolicy(corrupt_rate=1.0, corrupt_kind=kind),
                    TF.FaultPolicy(corrupt_rate=1.0, corrupt_kind=kind))
    j_out = JF.inject_corruption(_j(u), jnp.asarray(corrupt),
                                 jnp.asarray(uid, jnp.int32), j_pol)
    t_out = TF.inject_corruption({k: torch.tensor(v) for k, v in u.items()},
                                 torch.tensor(corrupt), torch.tensor(uid),
                                 t_pol)
    j_z, j_c = JF.finite_guard(j_out)
    t_z, t_c = TF.finite_guard(t_out)
    for j_tree, t_tree in ((j_out, t_out), (j_z, t_z), (j_c, t_c)):
        for k, a in _j_flat(j_tree).items():
            assert _same_bits(a, t_tree[k]), k


@pytest.mark.parametrize("clip", [0.5, 2.0, 1e3])
def test_clip_updates_matches_reference(clip):
    u = _updates(1)
    u["layers.0.w"][0, 0, :2] = 0.0
    u["layers.0.b"][3] = 0.0
    u["layers.0.w"][3] = 0.0                    # an all-zero row stays zero
    j_out = _j_flat(JF.clip_updates(_j(u), clip))
    t_out = TF.clip_updates({k: torch.tensor(v) for k, v in u.items()}, clip)
    for k, a in j_out.items():
        np.testing.assert_allclose(t_out[k].numpy(), a, rtol=1e-6, atol=0)
    assert not t_out["layers.0.w"][3].any()


@settings(deadline=None, max_examples=12)
@given(st.integers(0, 2**31 - 1), st.sampled_from(["nan", "inf", "bitflip"]),
       st.floats(0.05, 0.95))
def test_partial_corruption_is_quarantined(seed, kind, frac):
    """Below ``corrupt_frac=1`` (the port's own draw): the subset is a
    pure function of the uids, its share is near ``frac``, and after the
    guard each coordinate's aggregate is the weighted mean over exactly
    the clients whose element stayed finite — quarantined coverage leaves
    the denominator — and, with the norm clip bounding the huge finite
    values bit-flips leave, no non-finite value survives."""
    rng = np.random.default_rng(seed)
    C = 6
    u = {"layers.0.b": torch.tensor(rng.normal(size=(C, 16)), dtype=torch.float32),
         "layers.0.w": torch.tensor(rng.normal(size=(C, 32, 16)), dtype=torch.float32)}
    corrupt = torch.tensor(rng.random(C) < 0.7, dtype=torch.float32)
    uid = torch.tensor(rng.integers(0, 2**31, C))
    pol = TF.FaultPolicy(seed=seed, corrupt_rate=1.0, corrupt_kind=kind,
                         corrupt_frac=frac)
    out = TF.inject_corruption(u, corrupt, uid, pol)
    again = TF.inject_corruption(u, corrupt, uid, pol)
    hit = {k: (out[k].view(torch.int32) != u[k].view(torch.int32))
           for k in u}
    for k in u:
        assert torch.equal(out[k].view(torch.int32),
                           again[k].view(torch.int32))
        assert not hit[k][corrupt == 0].any()           # clean rows intact
    rows = hit["layers.0.w"][corrupt > 0].float()
    if rows.numel():
        assert abs(rows.mean().item() - frac) < 0.1
    part = torch.tensor(rng.random(C) < 0.8, dtype=torch.float32)
    zeroed, fin = TF.finite_guard(out)
    zeroed = TF.clip_updates(zeroed, 5.0)
    cov = {k: torch.tensordot(part, m, dims=1) for k, m in fin.items()}
    g_sum = {k: torch.tensordot(part, z, dims=1) for k, z in zeroed.items()}
    masks = {k: torch.ones(()) for k in u}
    acc = TA.zeros_like_acc({k: v[0] for k, v in u.items()}, dense_den=True)
    agg = TA.finalize(TA.accumulate_cohort(acc, g_sum, masks, 0.5,
                                           float(part.sum()), cov=cov))
    for k in u:
        w = part.reshape((-1,) + (1,) * (u[k].dim() - 1)) * fin[k]
        want = (w * zeroed[k]).sum(0) / torch.clamp_min(w.sum(0), TA.EPS)
        assert torch.isfinite(agg[k]).all()
        torch.testing.assert_close(agg[k], want, rtol=1e-6, atol=1e-6)


def test_partial_corruption_never_reaches_params():
    """End to end with subsets below 1: every kind, guarded, keeps the
    params finite; without the guard NaN does reach them."""
    fleet = T.FleetSpec.cycling(TIERS, 6, samples_per_client=16)
    local = T.LocalTraining(mode="fedavg", local_steps=2, local_lr=0.1)
    for kind, seed in (("nan", 1), ("inf", 2), ("bitflip", 3)):
        flt = T.FaultPolicy(seed=seed, corrupt_rate=0.6, corrupt_kind=kind,
                            corrupt_frac=0.4,
                            clip_norm=5.0 if kind == "bitflip" else None)
        res = T.simulate(T.FLScenario(fleet=fleet, local=local, faults=flt),
                         3, init_seed=seed, device="cpu")
        assert all(torch.isfinite(p).all() for p in res.params.values())
        assert sum(r.n_corrupt for r in res.records) > 0
    off = T.FaultPolicy(seed=0, corrupt_rate=1.0, corrupt_frac=0.5,
                        finite_guard=False)
    res = T.simulate(T.FLScenario(fleet=fleet, faults=off), 2, init_seed=1,
                     device="cpu")
    assert not all(torch.isfinite(p).all() for p in res.params.values())


# ------------------------------------------------------- runs end to end

SYNC = dict(seed=5, period=4, duty_cycle=0.75, churn_rate=0.1,
            dropout_rate=0.2, corrupt_rate=0.3, corrupt_kind="nan")
AVAIL = dict(seed=5, period=3, duty_cycle=0.67, churn_rate=0.15,
             dropout_rate=0.25)
# no availability trace, so the sync and async runs share it
UPLOAD = dict(seed=5, dropout_rate=0.2, retry_backoff=0.5,
              corrupt_rate=0.3, corrupt_kind="bitflip", clip_norm=1.0)


def _scenario(m, name: str):
    """Scenario ``name`` built from package ``m`` (J or T): fedsgd with
    fp8 uploads and error feedback on six clients."""
    fleet = m.FleetSpec.cycling(TIERS, 6, samples_per_client=16)
    ef = m.UploadPolicy(quant="fp8_e4m3", error_feedback=True)
    flt = JF.FaultPolicy if m is J else TF.FaultPolicy
    part = m.ParticipationPolicy(fraction=0.8, seed=7)
    return {
        "client": lambda: m.FLScenario(
            fleet=fleet, runtime="client", upload=ef, faults=flt(**SYNC)),
        "cohort_upload": lambda: m.FLScenario(
            fleet=fleet, upload=ef, participation=part,
            faults=flt(**UPLOAD)),
        "cohort_avail_deadline": lambda: m.FLScenario(
            fleet=fleet, upload=ef, participation=part,
            timing=m.SyncDrop(deadline=0.05), faults=flt(**AVAIL)),
        "async_upload": lambda: m.FLScenario(
            fleet=fleet, upload=ef,
            timing=m.AsyncBuffered(buffer_size=2, staleness_exp=0.5),
            faults=flt(**UPLOAD)),
    }[name]()


@functools.lru_cache(maxsize=None)
def _reference(name: str):
    """The reference's eager run of scenario ``name`` from its own params
    and shards (one run per scenario, shared by the engines)."""
    sc = _scenario(J, name)
    params = jmlp.init(jax.random.PRNGKey(0), config())
    shards = [jax.tree.map(np.asarray, c.data)
              for c in sc.fleet.build_clients()]
    ref = J.simulate(sc, ROUNDS, params=params, shards=shards)
    return params, shards, ref


RUNS = [("client", "eager"), ("cohort_upload", "eager"),
        ("cohort_upload", "scan"), ("cohort_avail_deadline", "eager"),
        ("cohort_avail_deadline", "scan"),
        ("cohort_avail_deadline", "scan_pallas"), ("async_upload", "eager"),
        ("async_upload", "scan")]


@pytest.mark.parametrize("name,engine", RUNS)
def test_faulted_run_matches_reference(name, engine):
    """Losses to rtol 1e-5 and params to atol 1e-5 of the reference's
    eager run; participants, deadline drops, dropouts and corrupted
    uploads exactly; ``None`` losses in the same rounds."""
    params, shards, ref = _reference(name)
    sc = T.FLScenario.from_dict(json.loads(json.dumps(
        _scenario(J, name).to_dict())))
    assert sc == _scenario(T, name)
    out = T.simulate(sc, ROUNDS, engine=engine, device="cpu",
                     params=params_from_numpy(jax.tree.map(np.asarray,
                                                           params)),
                     shards=shards_from_numpy(shards))
    count = ("n_participants", "n_dropped", "n_dropouts", "n_corrupt",
             "n_updates", "step")
    for a, b in zip(ref.records, out.records):
        assert [getattr(b, f) for f in count] == \
            [getattr(a, f) for f in count]
        assert (a.loss is None) == (b.loss is None)
        if a.loss is not None:
            np.testing.assert_allclose(b.loss, a.loss, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, ref.params)),
                    jax.tree.leaves(params_to_numpy(out.params))):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    assert sum((r.n_dropouts or 0) + r.n_corrupt for r in out.records) > 0


# ---------------------------------------------------- the port's own bars

def _same(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def test_inert_policy_is_bitwise_faults_none():
    """A policy with every axis off keeps the clean paths."""
    fleet = T.FleetSpec.cycling(TIERS, 6, samples_per_client=16)
    part = T.ParticipationPolicy(fraction=0.7, seed=3)
    for kw in ({"participation": part}, {"runtime": "client"}):
        a = T.simulate(T.FLScenario(fleet=fleet, **kw), 3, init_seed=1,
                       device="cpu")
        b = T.simulate(T.FLScenario(fleet=fleet, faults=T.FaultPolicy(seed=9),
                                    **kw), 3, init_seed=1, device="cpu")
        assert _same(a.params, b.params)
        assert [r.loss for r in a.records] == [r.loss for r in b.records]


def test_zero_participant_round_is_graceful():
    sc = T.FLScenario(fleet=T.FleetSpec.cycling(TIERS, 6),
                      faults=T.FaultPolicy(seed=0))
    srv = T.build_server(sc, MODEL, optim.sgd(0.1),
                         tmlp.init(torch.Generator().manual_seed(0), config()),
                         device="cpu")
    p0 = {k: v.clone() for k, v in srv.params.items()}
    rec = srv.round(participation=[np.zeros(c.size, bool)
                                   for c in srv.cohorts])
    assert rec["loss"] is None and rec["n_participants"] == 0
    assert _same(srv.params, p0)
    rec2 = srv.round()
    assert rec2["loss"] is not None and np.isfinite(rec2["loss"])
    # a round nobody joins, in the engines: the update is skipped
    dark = T.FaultPolicy(seed=0, dropout_rate=0.999)
    for engine in ("scan", "scan_pallas"):
        res = T.simulate(T.FLScenario(fleet=sc.fleet, faults=dark), 2,
                         engine=engine, device="cpu", init_seed=0)
        assert [r.loss for r in res.records] == [None, None]
        assert all(r.n_participants == 0 and r.n_dropouts == 6
                   for r in res.records)
        assert _same(res.params, p0)


def test_scan_pallas_refuses_upload_faults():
    sc = T.FLScenario(fleet=T.FleetSpec.cycling(TIERS, 6),
                      faults=T.FaultPolicy(seed=1, corrupt_rate=0.2))
    srv = T.build_server(sc, MODEL, optim.sgd(0.1),
                         tmlp.init(torch.Generator().manual_seed(0), config()),
                         device="cpu")
    with pytest.raises(ValueError, match="coverage"):
        T.ScanEngine(srv, agg="pallas")
    with pytest.raises(ValueError, match="coverage"):
        T.simulate(sc, 1, engine="scan_pallas", device="cpu")


@pytest.mark.parametrize("submodel", ["mask", "width"])
def test_async_scan_is_bitwise_eager_under_faults(submodel):
    sc = T.FLScenario(
        fleet=T.FleetSpec.cycling(("hub", "high", "mid", "low"), 16),
        local=T.LocalTraining(submodel=submodel),
        upload=T.UploadPolicy(quant="fp8_e4m3", error_feedback=True),
        timing=T.AsyncBuffered(buffer_size=4, staleness_exp=0.5,
                               time_jitter=0.2),
        faults=T.FaultPolicy(seed=3, dropout_rate=0.2, retry_backoff=0.5,
                             corrupt_rate=0.2, corrupt_kind="bitflip",
                             corrupt_frac=0.5, clip_norm=1.0))
    eager = T.simulate(sc, 8, device="cpu")
    scan = T.simulate(sc, 8, engine="scan", chunk_rounds=3, device="cpu")
    assert _same(eager.params, scan.params)
    assert eager.records == scan.records
    assert sum(r.n_corrupt for r in scan.records) > 0


@pytest.mark.parametrize("submodel,backend", [("mask", "pallas"),
                                              ("width", "pallas_structured")])
def test_scan_pallas_is_bitwise_scan_under_availability_faults(submodel,
                                                               backend):
    """Availability, churn and dropout faults run through the fused
    aggregation: tiers with nobody in a round add exact zeros."""
    sc = T.FLScenario(
        fleet=T.FleetSpec.cycling(("hub", "high", "mid", "low"), 16),
        local=T.LocalTraining(submodel=submodel),
        participation=T.ParticipationPolicy(fraction=0.5, seed=2),
        faults=T.FaultPolicy(seed=4, period=4, duty_cycle=0.5,
                             churn_rate=0.1, dropout_rate=0.3))
    scan = T.simulate(sc, 6, engine="scan", device="cpu")
    fused = T.simulate(sc, 6, engine="scan_pallas", device="cpu")
    eager = T.simulate(sc, 6, device="cpu")
    assert fused.agg_backend == backend
    assert _same(scan.params, fused.params) and _same(scan.params,
                                                      eager.params)
    assert [r.n_participants for r in fused.records] == \
        [r.n_participants for r in eager.records]
    assert min(r.n_participants for r in fused.records) < 8
