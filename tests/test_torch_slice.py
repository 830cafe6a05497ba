"""The port's FL round end to end against the reference: one scenario
JSON written by ``repro`` and read by ``repro_torch``, the reference's
params and shards carried across through numpy, ``simulate`` for 5
rounds on every engine. Plus the port's boundaries: it imports neither
JAX nor the reference, it never drops to the CPU on its own, and it
refuses what the reference refuses."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_mlp import config
from repro.core import scenario as J
from repro.models import mlp as jmlp
import repro_torch.fl as T
from repro_torch.interop import (params_from_numpy, params_to_numpy,
                                 shards_from_numpy)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIERS = ("hub", "high", "mid", "low")
ENGINES = ("eager", "scan", "scan_pallas")

SCENARIOS = {
    "sync_wait_partial": J.FLScenario(
        fleet=J.FleetSpec.cycling(TIERS, 16),
        participation=J.ParticipationPolicy(fraction=0.5, seed=11)),
    "sync_drop": J.FLScenario(fleet=J.FleetSpec.cycling(TIERS, 16),
                              timing=J.SyncDrop(deadline=0.004)),
    "width": J.FLScenario(
        fleet=J.FleetSpec.cycling(TIERS + ("embedded",), 10),
        local=J.LocalTraining(submodel="width"),
        participation=J.ParticipationPolicy(fraction=0.8, seed=3)),
    "fedavg": J.FLScenario(
        fleet=J.FleetSpec.cycling(TIERS, 8),
        local=J.LocalTraining(mode="fedavg", local_steps=3, local_lr=0.5)),
    "quant_ef": J.FLScenario(
        fleet=J.FleetSpec.cycling(TIERS, 8),
        upload=J.UploadPolicy(quant="fp8_e4m3", error_feedback=True),
        participation=J.ParticipationPolicy(fraction=0.6, seed=5)),
}


def check_slice_parity(name: str, engine: str, rounds: int = 5) -> None:
    """Losses to rtol 1e-5 and params to atol 1e-5 (the reference's own
    scan_pallas bar); participants and drops exactly; Eq. (1) wall time
    and bytes exactly for eager and to rtol 1e-6 for the engines that
    sum them in f32 on the device; the same agg_backend."""
    sc = SCENARIOS[name]
    params = jmlp.init(jax.random.PRNGKey(0), config())
    shards = [jax.tree.map(np.asarray, c.data)
              for c in sc.fleet.build_clients()]
    port_sc = T.FLScenario.from_dict(json.loads(json.dumps(sc.to_dict())))
    assert port_sc.to_dict() == sc.to_dict()
    ref = J.simulate(sc, rounds, params=params, shards=shards, engine=engine)
    out = T.simulate(port_sc, rounds, engine=engine, device="cpu",
                     params=params_from_numpy(jax.tree.map(np.asarray, params)),
                     shards=shards_from_numpy(shards))
    assert out.agg_backend == ref.agg_backend
    np.testing.assert_allclose(out.losses, ref.losses, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, ref.params)),
                    jax.tree.leaves(params_to_numpy(out.params))):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    rtol = 0.0 if engine == "eager" else 1e-6
    for a, b in zip(ref.records, out.records):
        assert (b.step, b.n_participants, b.n_dropped) == \
            (a.step, a.n_participants, a.n_dropped)
        np.testing.assert_allclose(b.round_wall_time, a.round_wall_time,
                                   rtol=rtol, atol=0)
        np.testing.assert_allclose(b.total_upload_bytes,
                                   a.total_upload_bytes, rtol=rtol, atol=0)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ["sync_wait_partial", "sync_drop", "width"])
def test_slice_matches_reference(name, engine):
    check_slice_parity(name, engine)


def test_simulate_without_device_never_drops_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = T.FLScenario(fleet=T.FleetSpec.cycling(TIERS, 4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.simulate(sc, 1)
    assert T.simulate(sc, 1, device="cpu").final.n_participants == 4


@pytest.mark.parametrize("case", ["async", "client", "faults", "topology",
                                  "mesh", "checkpoint", "census",
                                  "dirichlet", "topology_upload_faults"])
def test_unported_parts_raise(case, tmp_path):
    """The parts that were unported at first now run, or refuse what the
    reference refuses with its messages: a topology that does not cover
    the fleet ("fleet has"), a mesh on a flat fleet ("topology server"),
    upload faults on a topology fleet ("hierarchical"). The other cases
    (a fault policy on the async and per-client runtimes and in the
    census, checkpointing, the Dirichlet partition) run."""
    fleet = T.FleetSpec.cycling(TIERS, 4)
    sc = T.FLScenario(fleet=fleet)
    faults = T.FaultPolicy(dropout_rate=0.1)
    d = str(tmp_path)
    run = {
        "async": lambda: T.simulate(T.FLScenario(
            fleet=fleet, timing=T.AsyncBuffered(), faults=faults), 1,
            device="cpu"),
        "client": lambda: T.simulate(T.FLScenario(
            fleet=fleet, runtime="client", faults=faults), 1, device="cpu"),
        "faults": lambda: T.simulate(T.FLScenario(
            fleet=fleet, faults=faults), 1, device="cpu"),
        "topology": lambda: T.FleetSpec(tiers=TIERS,
                                        topology={"edges": [[0, 1]]}),
        "mesh": lambda: T.simulate(sc, 1, device="cpu", mesh=True),
        "checkpoint": lambda: T.simulate(sc, 1, device="cpu",
                                         checkpoint_every=1,
                                         checkpoint_dir=d),
        "census": lambda: T.scenario_census(T.FLScenario(
            fleet=fleet, faults=faults)),
        "dirichlet": lambda: T.simulate(T.FLScenario(fleet=T.FleetSpec(
            tiers=TIERS, n_samples=64, partition="dirichlet")), 1,
            device="cpu", checkpoint_every=1, checkpoint_dir=d),
        "topology_upload_faults": lambda: T.FLScenario(
            fleet=T.FleetSpec.cycling(TIERS, 8, edges=2,
                                      samples_per_client=16),
            faults=T.FaultPolicy(corrupt_rate=0.1)),
    }[case]
    refused = {"topology": "fleet has", "mesh": "topology server",
               "topology_upload_faults": "hierarchical"}
    if case in refused:
        with pytest.raises(ValueError, match=refused[case]):
            run()
        return
    out = run()
    if case == "census":
        assert out["faults"]["dropout_rate"] == 0.1
    else:
        assert out.final.loss is not None
    if case in ("checkpoint", "dirichlet"):
        assert T.latest_run_step(d) == 1


def test_port_imports_neither_jax_nor_reference():
    """Every module of repro_torch, and chip_smoke.py, import with
    ``jax`` blocked, and pull in no ``repro`` module."""
    code = (
        "import sys, pkgutil, importlib, runpy\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                   check=True, timeout=300)
    for dirpath, _, files in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        for f in files:
            if f.endswith((".py", ".cu")):
                src = open(os.path.join(dirpath, f)).read()
                for banned in ("import jax", "from jax", "from repro.",
                               "import repro."):
                    assert banned not in src, (f, banned)
