"""Dry runs: the LM dry run over every (architecture x input shape x
production mesh), and the census CLI of the FL runtimes, as the
reference's ``launch/dryrun.py``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun            # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --fl-async \\
      --fl-clients 256 --fl-buffer 64      # async schedule census only
  PYTHONPATH=src python -m repro_torch.launch.dryrun --fl-census scenario.json
      # declarative-scenario census (DESIGN.md §11): fleet, payload
      # bytes, Eq. (1) time table

The LM dry run writes one JSON per (arch, shape, mesh) under ``--out``
(default experiments/dryrun/), named as the reference names it. Its step
runs on fake tensors (``launch/specs.py``, ``launch/analysis.py``): no
tensor storage is allocated and no GPU is touched, so full-scale configs
run on a host. It is the reference's proof that the distribution config
is coherent: every record (train, prefill, decode) traces one rank's
step of the port's own sharded program at the production mesh's size
(256 or 512 ranks), so a layout mismatch or an unsupported split fails
the record. A record keeps
the reference's keys where the port has a counterpart:

  - ``status``, ``error`` / ``traceback``, ``wall_s``, ``params``,
    ``tokens_per_step``;
  - ``flops`` and ``traffic_bytes`` (GLOBAL, by the reference's rule:
    ``launch/analysis.py``, from the whole step's trace), and
    ``matmul_traffic_bytes``, the traffic's matmul and convolution term,
    which the reference's record lacks: it is the term the two programs
    count alike (the rest counts ATen ops, not jaxpr equations);
  - ``memory``: ``argument_size_in_bytes`` and ``output_size_in_bytes``
    per device (every leaf cut to its sharding's ``shard_shape``), and
    ``temp_size_in_bytes``, a trace's peak of live bytes beyond the
    arguments, with ``temp_exact`` False when a scan (the sLSTM's loop
    over time, the mLSTM's and Mamba2's chunk loops) was counted by its
    multiplier, whose two traced steps hold what the loop's N would, so
    the peak is then a lower bound. It is PER DEVICE
    (``temp_scope: "device"``): the peak of rank 0's trace
    (``launch.specs.rank_traced``: of a train step, its blocks of the
    FSDP train state and its rows of the batch, the FSDP leaves gathered
    where a layer uses them and gathered again in the backward; of a
    prefill, its blocks of the deployed params and its rows; of a decode
    step, its blocks of the deployed params and of the cache as
    ``cache_spec_tree`` places it);
  - ``trace_s`` where the reference has ``lower_s`` (the global trace),
    and ``rank_trace_s``, the rank's trace;
  - ``collectives``: the reference's ``collective_bytes`` keys,
    ``bytes_by_op``, ``count_by_op`` and ``total_bytes``, PER DEVICE:
    every collective rank 0's step runs (``models/parallel.py``'s,
    counted where it runs, op names in the reference's vocabulary:
    ``all-reduce``, ``all-gather``, ``reduce-scatter``), its bytes those
    of the rank's result, and a collective inside a scan counted times
    the scan's length, as the reference counts a while body times its
    trip count. The reference reads its census from the HLO that GSPMD
    partitioned; the port's collectives are its own layers', so the two
    differ op by op.

Left out, with no counterpart: ``compile_s``,
``memory.generated_code_size_in_bytes``, ``xla_flops_raw`` and
``xla_bytes_raw`` (XLA's compiler and its cost analysis). The global
step is traced once per (arch, shape, num_groups as the step uses it),
and the trace serves both meshes where those agree
(``launch.specs.traced``); a rank's trace is one per mesh.

The census CLI (``--fl-census``, ``--fl-async``) writes the reference's
file names and contents. Both are shapes and host arithmetic: the paper
MLP's few params sit in host memory, and nothing touches a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.checkpoint.checkpointer import named_leaves
from repro_torch.configs import ARCHS, SHAPES, get_config


def _write(out_dir: str, name: str, rec: dict) -> str:
    os.makedirs(out_dir, exist_ok=True)
    fn = os.path.join(out_dir, name)
    with open(fn, "w") as f:
        json.dump(rec, f, indent=1)
    return fn


# ------------------------------------------------------------- LM dry run

def param_counts(params) -> dict:
    total = sum(x.numel() for _, x in named_leaves(params))
    return {"total": int(total)}


def active_params(cfg, params_tree) -> int:
    """MoE-aware active parameter count (experts scaled by top-k/E)."""
    total = 0
    for p, leaf in named_leaves(params_tree):
        n = leaf.numel()
        if cfg.is_moe and "we_" in p:
            n = int(n * cfg.experts_per_token / cfg.num_experts)
        total += n
    return int(total)


def active_and_total(cfg) -> dict:
    from repro_torch.launch.specs import fake_mode
    from repro_torch.models import get_model
    with fake_mode():
        params = get_model(cfg).init(0, device="cpu")
    return {"total": param_counts(params)["total"],
            "active": active_params(cfg, params)}


def tokens_per_step(cfg, shape) -> int:
    if shape.mode == "decode":
        return shape.global_batch
    return shape.global_batch * shape.seq_len


def dry_run_step(cfg, shape, mesh, setup_kw: dict | None = None) -> dict:
    """The measured fields of a record: ``cfg``'s step at ``shape`` on
    ``mesh`` (``launch.specs.setup_for``), traced on fake tensors once
    for every mesh that shares the trace (``launch.specs.traced``); its
    temp bytes and collectives per device, from rank 0's trace of the
    sharded step (``launch.specs.rank_traced``)."""
    from repro_torch.launch.specs import rank_traced, setup_for, traced
    from repro_torch.models.sharding import shard_bytes
    setup_kw = setup_kw or {}
    step, args, in_sh, out_sh = setup_for(cfg, shape, mesh, **setup_kw)
    counts, out, trace_s = traced(cfg, shape, mesh, step, args, setup_kw)
    dev, _, rank_s = rank_traced(cfg, shape, mesh, setup_kw)
    return {"trace_s": trace_s,
            "rank_trace_s": rank_s,
            "memory": {
                "argument_size_in_bytes": shard_bytes(args, in_sh),
                "output_size_in_bytes": shard_bytes(out, out_sh),
                # one rank's peak; a lower bound when a scan was counted
                # by its multiplier
                "temp_size_in_bytes": dev["temp_bytes"],
                "temp_scope": "device",
                "temp_exact": dev["temp_exact"]},
            "flops": counts["flops"],                   # global
            "traffic_bytes": counts["traffic_bytes"],   # global, estimate
            "matmul_traffic_bytes": counts["matmul_traffic_bytes"],
            "collectives": dev["collectives"]}


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
            setup_kw: dict | None = None) -> dict:
    from repro_torch.launch.mesh import make_production_mesh
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "mode": shape.mode, "status": "error"}
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        rec.update(dry_run_step(cfg, shape, mesh, setup_kw), status="ok",
                   params=active_and_total(cfg),
                   tokens_per_step=tokens_per_step(cfg, shape))
    except Exception as e:  # noqa: BLE001 — record and keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["wall_s"] = round(time.time() - t0, 1)
    _write(out_dir, f"{arch}__{shape_name}__{mesh_name}.json", rec)
    return rec


def run_sweep(archs, shapes, meshes, out_dir: str,
              skip_existing: bool = False) -> list:
    """``run_one`` over every (arch, shape, multi_pod), with the
    reference's OK / ERR lines; returns the records run."""
    results = []
    for arch in archs:
        for sh in shapes:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                fn = os.path.join(out_dir, f"{arch}__{sh}__{mesh_name}.json")
                if skip_existing and os.path.exists(fn):
                    with open(fn) as f:
                        prev = json.load(f)
                    if prev.get("status") == "ok":
                        print(f"SKIP {arch} {sh} {mesh_name}")
                        continue
                r = run_one(arch, sh, mp, out_dir)
                flag = "OK " if r["status"] == "ok" else "ERR"
                coll = r.get("collectives", {}).get("total_bytes")
                print(f"{flag} {arch:24s} {sh:12s} {mesh_name:8s} "
                      f"wall={r['wall_s']}s "
                      + (r.get("error", "")[:120] if flag == "ERR" else
                         f"flops/dev={r['flops']:.3g} "
                         + ("coll=n/a" if coll is None
                            else f"coll={coll:.3g}B")),
                      flush=True)
                results.append(r)
    n_ok = sum(1 for r in results if r["status"] == "ok")
    print(f"\n{n_ok}/{len(results)} dry-runs OK")
    return results


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


def main(argv=None):
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
    archs = ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    return run_sweep(archs, shapes, meshes, args.out, args.skip_existing)


if __name__ == "__main__":
    main()
