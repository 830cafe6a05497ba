"""Port parity for the FL census CLI (``repro_torch.launch.dryrun``,
``--fl-census`` and ``--fl-async``): for the default 256-client fleet,
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


def test_lm_dry_run_is_not_ported(tmp_path):
    """Without an --fl-* flag the CLI raises, naming ROADMAP item 16b; the
    reference's LM arguments are accepted, so that this is the message a
    caller sees, and nothing is written."""
    with pytest.raises(NotImplementedError, match="item 16b"):
        dryrun.main(["--arch", "llama3.2-3b", "--shape", "train_4k",
                     "--mesh", "single", "--skip-existing", "--out",
                     str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
