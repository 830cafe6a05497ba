"""Quickstart: heterogeneous-device federated learning in ~20 lines.

One declarative ``FLScenario`` describes the whole experiment: a
six-device IoT fleet (server hub -> fp8 edge -> pruned tiers ->
MCU-class) jointly training ONE global model, each tier on its own
compressed variant, merged by the mask-aware aggregator. ``simulate()``
assembles the cohort runtime and runs it.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.fl import (FleetSpec, FLScenario, LocalTraining,
                            resolve_device, simulate)

ROUNDS = 30
SCENARIO = FLScenario(
    fleet=FleetSpec(tiers=("hub", "high", "mid", "mid", "low", "embedded"),
                    n_samples=1800),
    local=LocalTraining(mode="fedavg", local_steps=5, local_lr=1.0),
)


def tier_counts(scenario: FLScenario) -> dict[str, int]:
    """Clients per tier, in first-appearance order."""
    return {t: c for (t, _), c in scenario.fleet.counts().items()}


def run(scenario: FLScenario = SCENARIO, rounds: int = ROUNDS, *,
        device=None, params=None, shards=None):
    """``rounds`` rounds through the ``scan`` engine (chunks of rounds,
    one host sync per chunk), the same trajectory as the eager loop."""
    return simulate(scenario, rounds, engine="scan", device=device,
                    params=params, shards=shards)


def report(result) -> list[str]:
    """The script's lines after the tier counts: every fifth round's
    loss and Eq. (1) wall time, then the totals."""
    lines = [f"round {rec.step:3d}  global-model loss {rec.loss:.4f}  "
             f"round_wall {rec.round_wall_time * 1e3:.2f}ms"
             for rec in result.records[4::5]]
    lines.append(
        f"done — one global model from 6 differently-compressed devices; "
        f"simulated {result.sim_time:.2f}s of fleet time, "
        f"{sum(r.total_upload_bytes for r in result.records) / 1e3:.0f}kB "
        f"uploaded")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for tests)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print("tiers:", tier_counts(SCENARIO))
    result = run(SCENARIO, ROUNDS, device=device)
    for line in report(result):
        print(line)
    return result


if __name__ == "__main__":
    main()
