"""Durable runs in the port: the pytree checkpointer (mixed dtypes, bf16,
errors, retention), run-state discovery and its guards, kill-and-resume
bitwise on every runtime and engine, and checkpoints that cross between
the packages both ways — the reference's file format and leaf names."""
import json
import os
import shutil
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as j_optim
from repro.checkpoint import save_pytree as j_save_pytree
from repro.checkpoint.state import restore_run_state as j_restore
from repro.configs.paper_mlp import config
from repro.core import faults as JF
from repro.core import scenario as J
from repro.models import mlp as jmlp
import repro_torch.fl as T
from repro_torch import optim
from repro_torch.interop import (params_from_numpy, params_to_numpy,
                                 shards_from_numpy)
from repro_torch.models import mlp as tmlp

torch.set_num_threads(1)

MODEL = types.SimpleNamespace(loss_fn=tmlp.loss_fn)
TIERS = ("hub", "high", "mid", "low", "mid", "low")
FLEET = T.FleetSpec.cycling(TIERS, 6, samples_per_client=16)
LOCAL = T.LocalTraining(mode="fedavg", local_steps=2, local_lr=0.1)
EF = T.UploadPolicy(quant="fp8_e4m3", error_feedback=True)
SYNC_FAULTS = T.FaultPolicy(seed=5, period=4, duty_cycle=0.75,
                            churn_rate=0.1, dropout_rate=0.2,
                            corrupt_rate=0.3, corrupt_kind="nan")
ASYNC_FAULTS = T.FaultPolicy(seed=5, dropout_rate=0.2, retry_backoff=0.5,
                             max_retries=3, corrupt_rate=0.3,
                             corrupt_kind="inf")


def _params():
    return tmlp.init(torch.Generator().manual_seed(0), config())


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return np.frombuffer(t.numpy().tobytes(), np.uint8)


# ---------------------------------------------------- pytree checkpointer

def _tree():
    return {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4) * 0.1,
        "half": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
        "ints": torch.arange(5, dtype=torch.int32),
        "nested": {"a": (torch.ones((2, 2), dtype=torch.float16),
                         torch.tensor([3], dtype=torch.int64)),
                   "lst": [torch.tensor(2.5), torch.zeros(0)]},
        "empty": (),
    }


def test_mixed_dtype_round_trip(tmp_path):
    tree = _tree()
    p = str(tmp_path / "t.npz")
    T.save_pytree(tree, p)
    tmpl = {"w": torch.zeros(3, 4), "half": torch.zeros(2, dtype=torch.bfloat16),
            "ints": torch.zeros(5, dtype=torch.int32),
            "nested": {"a": (torch.zeros(2, 2, dtype=torch.float16),
                             torch.zeros(1, dtype=torch.int64)),
                       "lst": [torch.tensor(0.0), torch.zeros(0)]},
            "empty": ()}
    out = T.load_pytree(tmpl, p)
    assert out["empty"] == () and isinstance(out["nested"]["a"], tuple)
    assert isinstance(out["nested"]["lst"], list)
    flat = [out["w"], out["half"], out["ints"], *out["nested"]["a"],
            *out["nested"]["lst"]]
    ref = [tree["w"], tree["half"], tree["ints"], *tree["nested"]["a"],
           *tree["nested"]["lst"]]
    for a, b in zip(ref, flat):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))


def test_bf16_crosses_packages(tmp_path):
    """bf16 travels as its uint16 bits, in both directions."""
    vals = [1.0, 3.140625, -0.007812, 65280.0]
    p = str(tmp_path / "t.npz")
    j_save_pytree({"x": jnp.asarray(vals, jnp.bfloat16)}, p)
    out = T.load_pytree({"x": torch.zeros(4, dtype=torch.bfloat16)}, p)
    want = torch.tensor(vals, dtype=torch.bfloat16)
    assert out["x"].dtype == torch.bfloat16
    assert np.array_equal(_bits(out["x"]), _bits(want))
    T.save_pytree({"x": want}, p)
    from repro.checkpoint import load_pytree as j_load
    back = j_load({"x": jnp.zeros(4, jnp.bfloat16)}, p)
    assert back["x"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(back["x"]).view(np.uint16),
                          want.view(torch.int16).numpy().view(np.uint16))


def test_missing_leaf_and_shape_mismatch(tmp_path):
    p = str(tmp_path / "t.npz")
    T.save_pytree({"x": torch.ones(3)}, p)
    with pytest.raises(KeyError, match="missing leaf"):
        T.load_pytree({"y": torch.ones(3)}, p)
    with pytest.raises(ValueError, match="shape mismatch"):
        T.load_pytree({"x": torch.ones(4)}, p)


def test_retention_and_latest(tmp_path):
    ck = T.Checkpointer(str(tmp_path), keep=2)
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore({"x": torch.zeros(2)})
    for s in (1, 5, 9):
        ck.save({"x": torch.full((2,), float(s))}, s)
    assert ck.latest_step() == 9
    assert sorted(os.listdir(str(tmp_path))) == ["ckpt_00000005.npz",
                                                 "ckpt_00000009.npz"]
    restored, step = ck.restore({"x": torch.zeros(2)})
    assert step == 9 and float(restored["x"][0]) == 9.0
    restored, step = ck.restore({"x": torch.zeros(2)}, step=5)
    assert float(restored["x"][1]) == 5.0


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_leaf_names_are_the_reference_names(opt, tmp_path):
    """The port names each leaf as the reference names the same leaf of
    its tree: params, every optimizer state, EF and version stores."""
    j_params = jmlp.init(jax.random.PRNGKey(0), config())
    t_params = params_from_numpy(jax.tree.map(np.asarray, j_params))
    make = {"sgd": lambda m: m.sgd(1.0), "momentum": lambda m: m.momentum(0.1),
            "adam": lambda m: m.adam(0.1)}[opt]
    j_tree = {"params": j_params, "opt_state": make(j_optim).init(j_params),
              "ef": {"3": j_params}, "versions": {"7": j_params}}
    t_tree = {"params": t_params, "opt_state": make(optim).init(t_params),
              "ef": {"3": t_params}, "versions": {"7": t_params}}

    def names(path):
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
        return sorted((m["name"], m["dtype"]) for m in meta.values())
    j_save_pytree(j_tree, str(tmp_path / "j.npz"))
    T.save_pytree(t_tree, str(tmp_path / "t.npz"))
    got = names(str(tmp_path / "t.npz"))
    assert got == names(str(tmp_path / "j.npz"))
    assert ("params/layers/0/w", "float32") in got
    assert ("ef/3/layers/5/b", "float32") in got
    loaded = T.load_pytree(t_tree, str(tmp_path / "j.npz"))
    for k, v in loaded["params"].items():
        assert torch.equal(v, t_params[k])


# ------------------------------------------------------ run-state guards

def test_latest_run_step_and_retention(tmp_path):
    sc = T.FLScenario(fleet=FLEET)
    srv = T.build_server(sc, MODEL, optim.sgd(1.0), _params(), device="cpu")
    d = str(tmp_path)
    assert T.latest_run_step(d) is None
    assert T.latest_run_step(str(tmp_path / "absent")) is None
    for _ in range(5):
        srv.round()
        T.save_run_state(srv, d, scenario=sc, keep=2)
    assert T.latest_run_step(d) == 5
    assert sorted({int(f[6:14]) for f in os.listdir(d)}) == [4, 5]


def test_json_sidecar_is_the_commit_marker(tmp_path):
    sc = T.FLScenario(fleet=FLEET)
    d = str(tmp_path)
    T.simulate(sc, 2, init_seed=3, checkpoint_every=2, checkpoint_dir=d,
               device="cpu")
    step = T.latest_run_step(d)
    meta = json.load(open(os.path.join(d, f"state_{step:08d}.json")))
    assert meta["step"] == step == 2 and meta["schema"] == 1
    assert meta["server"] == "CohortFLServer"
    assert meta["scenario"] == sc.to_dict()
    open(os.path.join(d, "state_00000099.npz"), "wb").close()
    assert T.latest_run_step(d) == step


def test_scenario_and_server_kind_guards(tmp_path):
    timing = T.AsyncBuffered(buffer_size=2, staleness_exp=0.5)
    sc = T.FLScenario(fleet=FLEET, faults=ASYNC_FAULTS, timing=timing)
    d = str(tmp_path)
    T.simulate(sc, 3, init_seed=3, checkpoint_every=3, checkpoint_dir=d,
               device="cpu")
    other = T.FLScenario(fleet=FLEET, faults=ASYNC_FAULTS,
                         timing=T.AsyncBuffered(buffer_size=2,
                                                staleness_exp=0.25))
    with pytest.raises(ValueError, match="scenario mismatch"):
        T.simulate(other, 6, init_seed=3, resume_from=d, device="cpu")
    srv = T.build_server(T.FLScenario(fleet=FLEET, runtime="client"),
                         MODEL, optim.sgd(1.0), _params(), device="cpu")
    with pytest.raises(ValueError, match="cannot restore into"):
        T.restore_run_state(srv, d)
    with pytest.raises(ValueError, match="past rounds"):
        T.simulate(sc, 2, init_seed=3, resume_from=d, device="cpu")
    with pytest.raises(FileNotFoundError):
        T.simulate(sc, 2, resume_from=str(tmp_path / "none"), device="cpu")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        T.simulate(sc, 2, checkpoint_every=1, device="cpu")


# ----------------------------------------- kill-and-resume, bitwise

KILL_AND_RESUME = {
    "client_faults_ef": (T.FLScenario(
        fleet=FLEET, runtime="client", local=LOCAL, upload=EF,
        faults=SYNC_FAULTS), 6, 2, "eager"),
    "cohort_faults_ef": (T.FLScenario(
        fleet=FLEET, local=LOCAL, upload=EF,
        participation=T.ParticipationPolicy(fraction=0.8, seed=7),
        faults=SYNC_FAULTS), 6, 2, "eager"),
    "width_clean": (T.FLScenario(
        fleet=FLEET,
        local=T.LocalTraining(mode="fedavg", local_steps=2, local_lr=0.1,
                              submodel="width"),
        participation=T.ParticipationPolicy(fraction=0.8, seed=7)),
        6, 2, "eager"),
    "async_faults_ef": (T.FLScenario(
        fleet=FLEET, local=LOCAL, upload=EF,
        timing=T.AsyncBuffered(buffer_size=2, staleness_exp=0.5),
        faults=ASYNC_FAULTS), 8, 3, "eager"),
    "scan_sync_faults": (T.FLScenario(
        fleet=FLEET, local=LOCAL, upload=EF,
        participation=T.ParticipationPolicy(fraction=0.7, seed=7),
        faults=SYNC_FAULTS), 6, 2, "scan"),
    "scan_async_faults": (T.FLScenario(
        fleet=FLEET, local=LOCAL, upload=EF,
        timing=T.AsyncBuffered(buffer_size=3, staleness_exp=0.5),
        faults=ASYNC_FAULTS), 8, 3, "scan"),
    "scan_pallas_availability": (T.FLScenario(
        fleet=FLEET, upload=EF,
        faults=T.FaultPolicy(seed=5, period=4, duty_cycle=0.75,
                             churn_rate=0.1, dropout_rate=0.2)),
        6, 2, "scan_pallas"),
}


@pytest.mark.parametrize("name", sorted(KILL_AND_RESUME))
def test_kill_and_resume_is_bitwise(name, tmp_path):
    """A run checkpointed, cut and resumed (same runtime and engine) ends
    with the uninterrupted run's params bit for bit and every record
    equal."""
    sc, rounds, every, engine = KILL_AND_RESUME[name]
    d = str(tmp_path)
    full = T.simulate(sc, rounds, init_seed=3, engine=engine, device="cpu")
    cut = max(every, rounds // 2)
    T.simulate(sc, cut, init_seed=3, engine=engine, checkpoint_every=every,
               checkpoint_dir=d, device="cpu")
    res = T.simulate(sc, rounds, init_seed=3, engine=engine,
                     checkpoint_every=every, resume_from=d, device="cpu")
    assert all(torch.equal(full.params[k], res.params[k])
               for k in full.params)
    assert full.records == res.records
    assert T.latest_run_step(d) == rounds - rounds % every


# ------------------------------------------------ across the packages

UPLOAD = dict(seed=5, dropout_rate=0.2, retry_backoff=0.5,
              corrupt_rate=0.3, corrupt_kind="bitflip", clip_norm=1.0)
ROUNDS, CUT = 6, 3


def _cross_scenario(m, runtime: str):
    flt = JF.FaultPolicy if m is J else T.FaultPolicy
    fleet = m.FleetSpec.cycling(TIERS, 6, samples_per_client=16)
    ef = m.UploadPolicy(quant="fp8_e4m3", error_feedback=True)
    if runtime == "async":
        return m.FLScenario(fleet=fleet, upload=ef, faults=flt(**UPLOAD),
                            timing=m.AsyncBuffered(buffer_size=2,
                                                   staleness_exp=0.5,
                                                   time_jitter=0.2))
    return m.FLScenario(fleet=fleet, upload=ef, faults=flt(**UPLOAD),
                        participation=m.ParticipationPolicy(fraction=0.8,
                                                            seed=7))


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("runtime", ["cohort", "async"])
def test_checkpoints_cross_packages(runtime):
    """A reference run checkpointed at round 3 resumes in the port and
    matches the reference's uninterrupted run to the FL tolerance; a
    port checkpoint restores in the reference with equal params, EF
    buffers (and, async, version store and scheduler heap), and the
    reference continues it to the same end."""
    j_sc = _cross_scenario(J, runtime)
    t_sc = _cross_scenario(T, runtime)
    assert t_sc.to_dict() == j_sc.to_dict()
    params = jmlp.init(jax.random.PRNGKey(0), config())
    shards = [jax.tree.map(np.asarray, c.data)
              for c in j_sc.fleet.build_clients()]
    t_kw = dict(device="cpu", shards=shards_from_numpy(shards),
                params=params_from_numpy(jax.tree.map(np.asarray, params)))
    d = tempfile.mkdtemp()
    try:
        full = J.simulate(j_sc, ROUNDS, params=params, shards=shards)
        J.simulate(j_sc, CUT, params=params, shards=shards,
                   checkpoint_every=CUT, checkpoint_dir=d)
        out = T.simulate(t_sc, ROUNDS, resume_from=d, **t_kw)
        np.testing.assert_allclose(out.losses, full.losses, rtol=1e-5)
        for a, b in zip(_leaves(full.params),
                        jax.tree.leaves(params_to_numpy(out.params))):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
        assert [r.n_corrupt for r in out.records] == \
            [r.n_corrupt for r in full.records]

        shutil.rmtree(d)
        port = T.simulate(t_sc, CUT, checkpoint_every=CUT,
                          checkpoint_dir=d, **t_kw)
        srv = J.build_server(j_sc, types.SimpleNamespace(loss_fn=jmlp.loss_fn),
                             j_optim.sgd(1.0), params, shards=shards)
        assert j_restore(srv, d, scenario=j_sc) == CUT
        for a, b in zip(_leaves(srv.params),
                        jax.tree.leaves(params_to_numpy(port.params))):
            assert np.array_equal(a, b)
        t_srv = port.server
        for jc, tc in zip(srv.cohorts, t_srv.cohorts):
            assert (jc.ef_buffer is None) == (tc.ef_buffer is None)
            if tc.ef_buffer is not None:
                for a, b in zip(_leaves(jc.ef_buffer), jax.tree.leaves(
                        params_to_numpy(tc.ef_buffer))):
                    assert np.array_equal(a, b)
        if runtime == "async":
            assert srv._sched._heap == t_srv._sched._heap
            assert (srv._sched._seq, srv._sched._dispatches, srv._refs) == \
                (t_srv._sched._seq, t_srv._sched._dispatches, t_srv._refs)
            assert sorted(srv._versions) == sorted(t_srv._versions)
        for _ in range(ROUNDS - CUT):
            srv.step() if runtime == "async" else srv.round()
        for a, b in zip(_leaves(srv.params), _leaves(full.params)):
            assert np.array_equal(a, b)
    finally:
        shutil.rmtree(d, ignore_errors=True)
