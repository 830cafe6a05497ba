"""Host-only dry runs of the FL runtimes: the census CLI of the
reference's ``launch/dryrun.py``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --fl-async \\
      --fl-clients 256 --fl-buffer 64      # async schedule census only
  PYTHONPATH=src python -m repro_torch.launch.dryrun --fl-census scenario.json
      # declarative-scenario census (DESIGN.md §11): fleet, payload
      # bytes, Eq. (1) time table

Each writes one JSON file under ``--out`` (default experiments/dryrun/),
with the reference's file name and contents. Both are shapes and host
arithmetic: the paper MLP's few params sit in host memory, and nothing
touches a GPU.

The LM dry run (lowering every architecture x input shape on the
production meshes: ``--arch``, ``--shape``, ``--mesh``) is not ported yet
(ROADMAP queue 1 item 16b); without an ``--fl-*`` flag ``main`` raises
``NotImplementedError`` saying so.
"""
from __future__ import annotations

import argparse
import json
import os

import torch


def _write(out_dir: str, name: str, rec: dict) -> str:
    os.makedirs(out_dir, exist_ok=True)
    fn = os.path.join(out_dir, name)
    with open(fn, "w") as f:
        json.dump(rec, f, indent=1)
    return fn


def run_fl_async(out_dir: str, n_clients: int = 256, buffer_size: int = 64,
                 windows: int = 200, jitter: float = 0.1) -> dict:
    """Schedule-only dry run of the async FL runtime (DESIGN.md §10): the
    virtual-clock event schedule of a heterogeneous fleet without
    training, with its aggregation cadence and staleness histogram. An
    impossible buffer fails here, before a run is paid for."""
    from repro_torch.configs.paper_mlp import config as mlp_config
    from repro_torch.core.compression import DEVICE_TIERS
    from repro_torch.core.heterogeneity import PROFILES, round_time
    from repro_torch.core.scenario import FleetSpec
    from repro_torch.core.schedule import schedule_census
    from repro_torch.models import mlp

    params = mlp.init(torch.Generator().manual_seed(0), mlp_config())
    # speed mix: hub/mid/low profiles over the 4-plan tier cycle
    spec = FleetSpec.cycling(("hub", "high", "mid", "low"), n_clients,
                             profiles=("hub", "mid", "mid", "low"))
    sizes = spec.shard_sizes()
    times = [round_time(params, DEVICE_TIERS[t], PROFILES[p], sizes[i])["T"]
             for i, (t, p) in enumerate(zip(spec.tiers,
                                            spec.client_profiles))]
    rec = schedule_census(times, buffer_size, windows, seed=0,
                          jitter=jitter)
    rec.update(kind="fl_async_schedule", jitter=jitter)
    fn = _write(out_dir, f"fl_async__{n_clients}__buf{buffer_size}.json", rec)
    print(f"fl-async schedule census -> {fn}\n"
          f"  updates/s: async={rec['updates_per_s']:.1f} "
          f"sync-wait={rec['sync_updates_per_s']:.1f} "
          f"({rec['updates_per_s'] / rec['sync_updates_per_s']:.1f}x)  "
          f"staleness mean={rec['staleness_mean']:.2f} "
          f"max={rec['staleness_max']}")
    return rec


def run_fl_census(out_dir: str, scenario_json: str = "",
                  n_clients: int = 256) -> dict:
    """Declarative-scenario census (DESIGN.md §11): a scenario's fleet
    composition, per-round payload bytes and Eq. (1) time table, from
    shapes and host arithmetic. ``scenario_json`` is a file written from
    ``FLScenario.to_dict()``; empty means the reference 256-client
    hub/high/mid/low fleet."""
    from repro_torch.core.scenario import FleetSpec, FLScenario, scenario_census

    if scenario_json:
        with open(scenario_json) as f:
            scenario = FLScenario.from_dict(json.load(f))
    else:
        scenario = FLScenario(fleet=FleetSpec.cycling(
            ("hub", "high", "mid", "low"), n_clients))
    rec = scenario_census(scenario)

    timing = rec["scenario"]["timing"]
    print(f"fl-scenario census: {rec['n_clients']} clients "
          f"({rec['n_participants_per_round']}/round), "
          f"{rec['n_samples']} samples, mode={rec['scenario']['local']['mode']}, "
          f"timing={timing['kind']}, runtime={rec['scenario']['runtime']}")
    if not rec["shard_sizes_exact"]:
        print("  note: dirichlet shard sizes depend on the label draw; "
              "the table assumes even shards")
    print(f"  {'tier':10s} {'profile':10s} {'count':>5s} {'shard':>6s} "
          f"{'payload':>10s} {'T_local':>9s} {'T_up':>9s} {'T_down':>9s} "
          f"{'T':>9s}")
    for r in rec["tiers"]:
        print(f"  {r['tier']:10s} {r['profile']:10s} {r['count']:5d} "
              f"{r['n_shard']:6d} {r['payload_bytes']:9.0f}B "
              f"{r['T_local']:9.4f} {r['T_upload']:9.4f} "
              f"{r['T_download']:9.4f} {r['T']:9.4f}")
    print(f"  total upload/round (expected): "
          f"{rec['total_upload_bytes_per_round']:.0f}B")
    if "edge_groups" in rec:
        # hierarchical fleet (DESIGN.md §16): who reports at each edge,
        # the group's Eq. (1) critical path and device -> edge uplink, and
        # the edge -> hub traffic, which never depends on the client count
        print(f"  topology: {rec['n_edges']} edge groups, edge->hub "
              f"{rec['cross_shard_bytes_per_round']:.0f}B/round "
              f"(client-count independent)")
        print(f"  {'edge':>4s} {'clients':>7s} {'active_max':>10s} "
              f"{'T_round':>9s} {'uplink':>12s}")
        for g in rec["edge_groups"]:
            print(f"  {g['edge']:4d} {g['clients']:7d} "
                  f"{g['active_params_max']:10.0f} "
                  f"{g['round_wall_time']:9.4f} {g['uplink_bytes']:11.0f}B")
    if "round_wall_time" in rec:
        drop = rec.get("n_dropped_by_deadline")
        print(f"  round wall time: {rec['round_wall_time']:.4f}s"
              + (f"  (deadline drops {drop} clients)" if drop else ""))
    else:
        print(f"  async buffer={rec['buffer_size']}: dispatch T in "
              f"[{rec['dispatch_T_min']:.4f}, {rec['dispatch_T_max']:.4f}]s")
    fn = _write(out_dir,
                f"fl_scenario__{rec['n_clients']}__{timing['kind']}.json", rec)
    print(f"  -> {fn}")
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--fl-async", action="store_true",
                    help="async FL schedule census only (DESIGN.md §10)")
    ap.add_argument("--fl-census", nargs="?", const="", default=None,
                    metavar="SCENARIO_JSON",
                    help="declarative-scenario census (DESIGN.md §11): "
                         "pass an FLScenario.to_dict() JSON file, or no "
                         "value for the reference 256-client fleet")
    ap.add_argument("--fl-clients", type=int, default=256)
    ap.add_argument("--fl-buffer", type=int, default=64)
    ap.add_argument("--fl-windows", type=int, default=200)
    ap.add_argument("--fl-jitter", type=float, default=0.1)
    args = ap.parse_args(argv)

    if args.fl_census is not None:
        return run_fl_census(args.out, scenario_json=args.fl_census,
                             n_clients=args.fl_clients)
    if args.fl_async:
        return run_fl_async(args.out, n_clients=args.fl_clients,
                            buffer_size=args.fl_buffer,
                            windows=args.fl_windows, jitter=args.fl_jitter)
    raise NotImplementedError(
        "the LM dry run (--arch / --shape / --mesh) is not ported yet: "
        "ROADMAP queue 1 item 16b; pass --fl-census or --fl-async")


if __name__ == "__main__":
    main()
