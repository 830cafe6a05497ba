"""Port parity for the dry-run CLI (``repro_torch.launch.dryrun``). The
LM dry run: its record's keys, and the reference's parameter and token
counts for every arch; on a one-device host mesh its bytes and flops are
a real step's. The FL census (``--fl-census`` and ``--fl-async``): for
the default 256-client fleet,
a Dirichlet fleet, an 8-edge topology, a sync-drop fleet under faults,
an async fleet and the async schedule census, the port's CLI writes the
reference's JSON files, the same names and exactly equal contents (the
census is host float64 arithmetic in the reference's order, so no
tolerance is needed).

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` to 512 host
devices when it is imported, which would change JAX's device count for
every test that the same worker collects after it. So the reference CLI
runs only in a subprocess (one, for every case), never by ``import``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, get_config, \
    get_smoke_config
from repro_torch.core.faults import FaultPolicy
from repro_torch.core.scenario import (AsyncBuffered, FleetSpec, FLScenario,
                                       LocalTraining, ParticipationPolicy,
                                       SyncDrop)
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parent.parent
BENCH = ("hub", "high", "mid", "low")
PAPER_FLEET = ("hub", "high", "high", "mid", "mid", "low", "low", "embedded")

SCENARIOS = {
    "dirichlet": FLScenario(
        fleet=FleetSpec(tiers=PAPER_FLEET, n_samples=4000,
                        partition="dirichlet", alpha=0.5),
        local=LocalTraining(mode="fedavg", local_steps=5, local_lr=1.0)),
    "edges8": FLScenario(
        fleet=FleetSpec.cycling(BENCH, 256, edges=8),
        participation=ParticipationPolicy(fraction=0.5)),
    "drop_faults": FLScenario(
        fleet=FleetSpec.cycling(BENCH, 64), timing=SyncDrop(deadline=0.004),
        faults=FaultPolicy(period=24, duty_cycle=0.7, churn_rate=0.05,
                           dropout_rate=0.1)),
    "async": FLScenario(
        fleet=FleetSpec.cycling(BENCH, 256),
        timing=AsyncBuffered(buffer_size=64, time_jitter=0.2)),
}
ARGV = {
    "default": ["--fl-census"],
    "clients64": ["--fl-census", "--fl-clients", "64"],
    **{name: ["--fl-census", f"{name}.json"] for name in SCENARIOS},
    "async_schedule": ["--fl-async"],
    "async_schedule_small": ["--fl-async", "--fl-clients", "48",
                             "--fl-buffer", "8", "--fl-windows", "30",
                             "--fl-jitter", "0.3"],
}

# runs the reference's CLI once per case, in one process: argv[1] is
# {case: [args...]}, argv[2] the directory the cases' outputs go under
_REFERENCE_DRIVER = """
import json, os, sys
from repro.launch import dryrun
cases, root = json.loads(sys.argv[1]), sys.argv[2]
for name, args in cases.items():
    sys.argv = ["dryrun", *args, "--out", os.path.join(root, name)]
    dryrun.main()
"""


def _scenario_files(where: Path) -> None:
    for name, sc in SCENARIOS.items():
        (where / f"{name}.json").write_text(json.dumps(sc.to_dict()))


def _args(case: str, where: Path) -> list:
    return [str(where / a) if a.endswith(".json") else a
            for a in ARGV[case]]


@pytest.fixture(scope="module")
def reference(tmp_path_factory) -> Path:
    """The reference CLI's output directory, one subdirectory per case."""
    root = tmp_path_factory.mktemp("reference")
    _scenario_files(root)
    cases = {c: _args(c, root) for c in ARGV}
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    env.pop("XLA_FLAGS", None)
    subprocess.run([sys.executable, "-c", _REFERENCE_DRIVER,
                    json.dumps(cases), str(root / "out")],
                   check=True, env=env, cwd=str(root),
                   capture_output=True, timeout=300)
    return root / "out"


def _read(directory: Path) -> dict:
    return {p.name: json.loads(p.read_text())
            for p in sorted(directory.glob("*.json"))}


@pytest.mark.parametrize("case", list(ARGV))
def test_cli_writes_reference_json(case, reference, tmp_path, capsys):
    """The port's CLI on the same arguments (and scenario files) writes
    files of the reference's names with equal contents, and returns the
    record it wrote."""
    _scenario_files(tmp_path)
    out = tmp_path / "out"
    rec = dryrun.main([*_args(case, tmp_path), "--out", str(out)])
    mine, ref = _read(out), _read(reference / case)
    assert len(ref) == 1 and list(mine) == list(ref)
    assert mine == ref
    assert json.loads(json.dumps(rec)) == next(iter(mine.values()))
    assert "->" in capsys.readouterr().out


def test_census_records_the_scenario_features(reference):
    """The scenario cases exercise the census's optional parts: the
    edge table, the fault summary, the deadline drops and the async
    buffer."""
    recs = {c: next(iter(_read(reference / c).values())) for c in SCENARIOS}
    assert recs["edges8"]["n_edges"] == 8 and \
        len(recs["edges8"]["edge_groups"]) == 8
    assert recs["edges8"]["n_participants_per_round"] == 128
    assert "faults" in recs["drop_faults"] and \
        "n_dropped_by_deadline" in recs["drop_faults"]
    assert recs["async"]["buffer_size"] == 64
    assert not recs["dirichlet"]["shard_sizes_exact"]


def test_lm_dry_run_is_not_ported(tmp_path, monkeypatch, capsys):
    """Without an --fl-* flag the CLI runs the LM dry run (ROADMAP item
    16b, once refused here): at llama3.2-3b's smoke config it writes the
    reference's file name with the record's keys, and --skip-existing
    skips an ok record."""
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    argv = ["--arch", "llama3.2-3b", "--shape", "decode_32k", "--mesh",
            "single", "--skip-existing", "--out", str(tmp_path / "out")]
    recs = dryrun.main(argv)
    fn = tmp_path / "out" / "llama3.2-3b__decode_32k__16x16.json"
    rec = json.loads(fn.read_text())
    assert [r["status"] for r in recs] == ["ok"] and rec == recs[0]
    assert set(rec) == {"arch", "shape", "mesh", "mode", "status", "trace_s",
                        "memory", "flops", "traffic_bytes",
                        "matmul_traffic_bytes", "collectives",
                        "params", "tokens_per_step", "wall_s"}
    assert set(rec["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes", "temp_scope",
                                  "temp_exact"}
    assert rec["memory"]["temp_scope"] == "global"
    assert rec["memory"]["temp_exact"]
    assert rec["collectives"] == {"measured": False}
    assert rec["flops"] > 0 and rec["memory"]["temp_size_in_bytes"] > 0
    out = capsys.readouterr().out
    assert "OK  llama3.2-3b" in out and "coll=n/a" in out
    assert dryrun.main(argv) == []
    assert "SKIP llama3.2-3b decode_32k 16x16" in capsys.readouterr().out


_REFERENCE_COUNTS = """
import json
from repro.configs import ARCHS, SHAPES, get_config
from repro.launch import dryrun
print(json.dumps({a: {"params": dryrun.active_and_total(get_config(a)),
                      "tokens": {s: dryrun.tokens_per_step(get_config(a), sh)
                                 for s, sh in SHAPES.items()}}
                  for a in ARCHS}))
"""


@pytest.fixture(scope="module")
def reference_counts() -> dict:
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REFERENCE_COUNTS], env=env,
                         check=True, capture_output=True, text=True,
                         timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_tokens_match_reference(arch, reference_counts):
    """``active_and_total`` (MoE experts scaled by top-k / E) at the full
    config, counted on fake tensors, and ``tokens_per_step`` per shape."""
    cfg = get_config(arch)
    assert dryrun.active_and_total(cfg) == reference_counts[arch]["params"]
    assert {s: dryrun.tokens_per_step(cfg, sh) for s, sh in SHAPES.items()} \
        == reference_counts[arch]["tokens"]


def test_dry_run_on_a_host_mesh_matches_a_real_step():
    """whisper-tiny's smoke train step on a one-card host mesh (as the
    card's, traced here with no GPU): the argument and output bytes are
    those of the real state, batch and outputs on the CPU, and the flops
    are FlopCounterMode's over the real step."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import optim
    from repro_torch.core.compression import default_tier_plans
    from repro_torch.core.steps import TrainState, make_hetero_train_step
    from repro_torch.data.synthetic import make_train_batch
    from repro_torch.launch.analysis import nbytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    cfg = get_smoke_config("whisper-tiny")
    shape = ShapeConfig("cli", 16, 8, "train")
    # the card's host mesh: the dry run places nothing on its device
    mesh = make_host_mesh(2, devices=[torch.device("cuda")])
    rec = dryrun.dry_run_step(cfg, shape, mesh)
    model = get_model(cfg)
    opt = optim.adamw(optim.warmup_cosine(3e-4, 100, 10_000))
    state = TrainState.create(model, opt, 0, device="cpu")
    batch = make_train_batch(cfg, shape, n_tiers=4)
    step = make_hetero_train_step(model, opt, default_tier_plans(4))
    with FlopCounterMode(display=False) as fc:
        out = step(state, batch)
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == nbytes((state, batch))
    assert mem["output_size_in_bytes"] == nbytes(out)
    assert rec["flops"] == fc.get_total_flops() > 0


def test_a_step_is_traced_once_for_both_meshes(monkeypatch):
    """A prefill's setup (its cache's shardings) and its record share one
    trace, and the two production meshes share it too: one trace for the
    two records."""
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_production_mesh
    calls = []
    trace = specs.trace_step

    def counted(*a, **k):
        calls.append(1)
        return trace(*a, **k)
    monkeypatch.setattr(specs, "trace_step", counted)
    monkeypatch.setattr(specs, "_TRACES", {})
    cfg = get_smoke_config("llama3.2-3b")
    shape = ShapeConfig("p", 64, 32, "prefill")
    recs = [dryrun.dry_run_step(cfg, shape, make_production_mesh(
        multi_pod=mp)) for mp in (False, True)]
    assert len(calls) == 1
    assert recs[0]["flops"] == recs[1]["flops"] > 0
    # the batch shards 16 and 32 ways
    assert recs[0]["memory"]["argument_size_in_bytes"] > \
        recs[1]["memory"]["argument_size_in_bytes"]
