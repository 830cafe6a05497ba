"""FL simulation: the paper's full system loop with an 8-device
heterogeneous IoT fleet, expressed as declarative ``FLScenario`` specs.
Each experiment is ONE frozen spec composed of policy objects (fleet x
local training x upload x participation x timing), and ``simulate()``
assembles and drives the right runtime. Compared here:

  1. uncompressed FedSGD (McMahan et al. baseline: all devices big enough)
  2. hetero-compressed FedSGD (mask-aware aggregation)
  3. hetero-compressed FedAvg (5 local steps, compressed-space training)
  4. fp8 upload quantization with error feedback

reporting the paper's Eq. (1) per-round wall time and upload bytes, then
the cohort runtime and the at-scale scenarios it unlocks: partial
participation, a straggler deadline, masked against structured
width-sliced tiers (the same tier budgets spent as real smaller dense
sub-models instead of full-shape masks), and the asynchronous
staleness-aware runtime, where buffered aggregation stops the slow tiers
from gating the virtual clock.

  PYTHONPATH=src python -m repro_torch.examples.hetero_fl_sim [--device cpu]

The validation set is drawn from ``torch.Generator().manual_seed(9)``
and the fleets' data and init from the port's generators, so the
numbers are the port's own; ``run`` takes the reference's params and
shards where a caller wants its numbers.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.data import make_gaussian_dataset
from repro_torch.examples import sync
from repro_torch.fl import (AsyncBuffered, FleetSpec, FLScenario,
                            LocalTraining, ParticipationPolicy, ScanEngine,
                            SyncDrop, UploadPolicy, resolve_device,
                            scenario_census, simulate)
from repro_torch.models import mlp

ROUNDS = 60
FLEET = ("hub", "high", "high", "mid", "mid", "low", "low", "embedded")
VAL_SEED, VAL_SAMPLES = 9, 1000

# non-IID (label-skew Dirichlet) split for the faithful per-client loop;
# the cohort and async runtimes stack each cohort's shards and truncate
# ragged shards to the common floor, so they use equal IID shards to
# keep every sample in play
NONIID = FleetSpec(tiers=FLEET, n_samples=4000, partition="dirichlet",
                   alpha=0.5)
IID = FleetSpec(tiers=FLEET, n_samples=4000)

# (label, scenario) of each section's run(...) lines, in the script's order
CLIENT = (
    ("fedsgd (all-hub baseline)",
     FLScenario(fleet=FleetSpec(tiers=("hub",) * len(FLEET), n_samples=4000,
                                partition="dirichlet"),
                runtime="client")),
    ("fedsgd hetero-compressed", FLScenario(fleet=NONIID, runtime="client")),
    ("fedavg hetero-compressed",
     FLScenario(fleet=NONIID, runtime="client",
                local=LocalTraining(mode="fedavg", local_steps=5,
                                    local_lr=1.0))),
    ("fedsgd hetero + fp8 upload+EF",
     FLScenario(fleet=NONIID, runtime="client",
                upload=UploadPolicy(quant="fp8_e4m3", error_feedback=True))),
)
COHORT = (
    ("cohort fedsgd (IID shards)", FLScenario(fleet=IID)),
    ("cohort + 50% participation",
     FLScenario(fleet=IID, participation=ParticipationPolicy(fraction=0.5,
                                                             seed=1))),
    ("cohort + 5ms deadline drop",
     FLScenario(fleet=IID, timing=SyncDrop(deadline=0.005))),
)
MASKED = FLScenario(fleet=IID)
WIDTH = FLScenario(fleet=IID, local=LocalTraining(submodel="width"))
STRUCTURED = (("cohort fedsgd masked tiers", MASKED),
              ("cohort fedsgd width-sliced", WIDTH))
ASYNC = (
    ("async buffer=4, a=0.5",
     FLScenario(fleet=IID, timing=AsyncBuffered(buffer_size=4,
                                                staleness_exp=0.5))),
    ("async buffer=2 + jitter",
     FLScenario(fleet=IID,
                timing=AsyncBuffered(buffer_size=2, staleness_exp=0.5,
                                     time_jitter=0.2),
                participation=ParticipationPolicy(seed=1))),
)


def validation_set(device) -> dict:
    """The 1000 held-out samples every run is scored on."""
    val = make_gaussian_dataset(torch.Generator().manual_seed(VAL_SEED),
                                VAL_SAMPLES)
    return {k: v.to(device) for k, v in val.items()}


def run(name: str, scenario: FLScenario, *, rounds: int, val: dict, device,
        params=None, shards=None) -> dict:
    """One declarative experiment: ``simulate()`` builds the runtime the
    scenario's policies call for (per-client loop, cohort, or async).
    Prints the script's line and returns its values: ``loss``,
    ``val_acc`` and the line's other fields (``virtual_t``,
    ``staleness_mean``, ``staleness_max`` for async runs, else
    ``round_wall`` and ``participants``, ``n_clients``, ``dropped`` or
    ``upload_kB``), with the ``result`` and the run's wall ``seconds``."""
    sync(device)
    t0 = time.perf_counter()
    res = simulate(scenario, rounds, device=device, params=params,
                   shards=shards)
    sync(device)
    seconds = time.perf_counter() - t0
    rec = res.final
    acc = mlp.accuracy(res.params, val["x"], val["y"]).item()
    out = {"loss": rec.loss, "val_acc": acc}
    if rec.t is not None:
        out.update(virtual_t=rec.t, staleness_mean=rec.staleness_mean,
                   staleness_max=rec.staleness_max)
        extra = (f"virtual_t={rec.t:.3f}s "
                 f"staleness={rec.staleness_mean:.1f}/{rec.staleness_max}")
    elif rec.n_participants is not None:
        out.update(round_wall=rec.round_wall_time,
                   participants=rec.n_participants,
                   n_clients=scenario.fleet.n_clients, dropped=rec.n_dropped)
        extra = (f"round_wall={rec.round_wall_time:.3f}s "
                 f"participants={rec.n_participants}/"
                 f"{scenario.fleet.n_clients} dropped={rec.n_dropped}")
    else:
        out.update(round_wall=rec.round_wall_time,
                   upload_kB=rec.total_upload_bytes / 1e3)
        extra = (f"round_wall={rec.round_wall_time:.3f}s "
                 f"upload={rec.total_upload_bytes / 1e3:.1f}kB")
    print(f"{name:28s} loss={rec.loss:.4f} val_acc={acc:.3f} {extra}")
    return {**out, "result": res, "seconds": seconds}


def census_line(name: str, census: dict) -> str:
    """What the masked or width-sliced tiers upload per round, and the
    low tier's local time and payload, from ``scenario_census``."""
    low = next(r for r in census["tiers"] if r["tier"] == "low")
    return (f"  {name:12s} per-round upload "
            f"{census['total_upload_bytes_per_round'] / 1e3:6.1f}kB   "
            f"low-tier T_local={low['T_local'] * 1e3:.3f}ms "
            f"payload={low['payload_bytes']:.0f}B")


def scan_block(rounds: int, device) -> dict:
    """Eager against the ``scan`` engine on the IID cohort fleet: whether
    the two trajectories' params are bitwise equal (and their largest
    difference), then the steady-state rounds/s of both on warmed
    servers (no fleet build), each timed between device syncs."""
    eager = simulate(FLScenario(fleet=IID), rounds, device=device)
    scan = simulate(FLScenario(fleet=IID), rounds, engine="scan",
                    device=device)
    identical = all(torch.equal(eager.params[k], scan.params[k])
                    for k in eager.params)
    max_diff = max((eager.params[k] - scan.params[k]).abs().max().item()
                   for k in eager.params)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(rounds):
        eager.server.round()
    sync(device)
    t_eager = time.perf_counter() - t0
    engine = ScanEngine(scan.server, chunk_rounds=rounds)
    engine.run(rounds)                               # warm
    sync(device)
    t0 = time.perf_counter()
    engine.run(rounds)
    sync(device)
    t_scan = time.perf_counter() - t0
    return {"identical": identical, "max_abs_diff": max_diff,
            "eager_rounds_per_s": rounds / t_eager,
            "scan_rounds_per_s": rounds / t_scan}


def main(argv=None) -> dict:
    """Prints the script's lines; returns each ``run`` line's values by
    label (in the printed order), the census lines under ``"census"``
    and the scan block's values under ``"scan"``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for tests)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    val = validation_set(device)
    out: dict = {}

    def runs(pairs):
        for name, sc in pairs:
            out[name] = run(name, sc, rounds=ROUNDS, val=val, device=device)

    print(f"fleet: {list(FLEET)}\n")
    runs(CLIENT)
    print("\nnote: the compressed fleet trains the SAME global model while "
          "the low tiers ship 4-25x smaller payloads (the paper's Eq. 1 "
          "win).")
    print("\ncohort-vectorized runtime (one batched dispatch per plan):")
    runs(COHORT)
    print("\nmasked emulation vs structured width-sliced sub-models: same "
          "tier budgets, but submodel='width' cuts REAL smaller dense "
          "models\nout of the global one (a 0.25 tier trains a "
          "ceil(0.25*d) wide sub-network) and the server scatter-aggregates "
          "per coordinate:")
    runs(STRUCTURED)
    out["census"] = []
    for name, sc in (("masked", MASKED), ("width-sliced", WIDTH)):
        out["census"].append(census_line(name, scenario_census(sc)))
        print(out["census"][-1])
    print("\nasync staleness-aware runtime (virtual clock + buffered "
          "aggregation):")
    runs(ASYNC)
    print("\nmulti-round scan engine (chunks of rounds with participation "
          "precomputed on the host, one host sync per chunk):")
    s = out["scan"] = scan_block(ROUNDS, device)
    print(f"eager loop: {s['eager_rounds_per_s']:6.1f} rounds/s    "
          f"scan engine: {s['scan_rounds_per_s']:6.1f} rounds/s "
          f"(steady state)")
    print(f"trajectories bit-identical: {s['identical']}"
          + (" — a drop-in replacement" if s["identical"] else
             f" — params differ by at most {s['max_abs_diff']:.3g}"))
    return out


if __name__ == "__main__":
    main()
