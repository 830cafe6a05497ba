"""Bitwise run checkpointing for the federated runtimes, in the
reference's format (``src/repro/checkpoint/state.py``): either package
resumes a run the other checkpointed.

:func:`save_run_state` writes everything a runtime needs to continue a
trajectory — params, optimizer state, the per-client or per-cohort
error-feedback buffers, the async version store, the scheduler's heap
and counters, the round history — as one
:func:`~repro_torch.checkpoint.checkpointer.save_pytree` npz (tensors)
plus a JSON sidecar (scalars and the scenario), written after the npz:
the sidecar is the commit marker. :func:`restore_run_state` loads the
pair into a freshly built server of the same kind.

Why this is bitwise: every stochastic draw in the runtimes is stateless
per round (participation ``default_rng([seed, step])``, fault masks
``default_rng([fault_seed, tag, step])``, dispatch jitter and retry
delays per ``(seed, client, dispatch)``), so the counters are the whole
RNG state and they are exact integers; tensors round-trip exactly
through npz, and the scheduler's float64 times through JSON.

Restoring under a scenario whose ``to_dict()`` differs from the saved
one raises: the trajectory would match neither run.
"""
from __future__ import annotations

import json
import os
import re
import tempfile

import torch

from repro_torch.checkpoint.checkpointer import load_pytree, save_pytree
from repro_torch.core.topology import EdgeCohort, edge_sharding, unshard

_SCHEMA = 1


def _path(directory: str, step: int, ext: str) -> str:
    return os.path.join(directory, f"state_{step:08d}.{ext}")


def _steps(directory: str) -> list[int]:
    return sorted(int(m.group(1)) for f in os.listdir(directory)
                  if (m := re.match(r"state_(\d+)\.json$", f)))


def latest_run_step(directory: str) -> int | None:
    """The newest checkpoint step in ``directory`` (None when there is
    none). Only steps whose JSON sidecar exists count: it is written
    after the npz, so its presence implies a complete pair."""
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def _cohort_ef_template(server, ci: int) -> dict:
    """Zero residuals shaped like cohort ``ci``'s EF buffer (made lazily
    by the runtime, so a fresh server may not have one yet): ``(size,
    ...)`` for a cohort, ``(E, cap, ...)`` for an edge grid, on the
    server's (hub) device."""
    from repro_torch.core.federated import (_init_cohort_ef, _init_edge_ef,
                                            _local_param_struct)
    cohort = server.cohorts[ci]
    struct = _local_param_struct(server.params, cohort.plan)
    if isinstance(cohort, EdgeCohort):
        return _init_edge_ef(cohort.n_edges, cohort.cap, struct)
    return _init_cohort_ef(cohort.size, struct)


def save_run_state(server, directory: str, *, scenario=None,
                   keep: int = 3) -> str:
    """Snapshot ``server`` into ``directory`` as
    ``state_{step:08d}.{npz,json}``, keeping the newest ``keep`` pairs.
    Returns the npz path. ``scenario`` is embedded for the restore-time
    mismatch guard."""
    kind = type(server).__name__
    arrays = {"params": server.params, "opt_state": server.opt_state}
    meta = {"schema": _SCHEMA, "server": kind,
            "scenario": None if scenario is None else scenario.to_dict(),
            "history": server.history}
    if kind == "FLServer":
        step = server.step
        ef_clients = [i for i, c in enumerate(server.clients)
                      if c.ef_buffer is not None]
        meta["ef_clients"] = ef_clients
        arrays["client_ef"] = {str(i): server.clients[i].ef_buffer
                               for i in ef_clients}
    else:
        idx = [ci for ci, c in enumerate(server.cohorts)
               if c.ef_buffer is not None]
        meta["ef_cohorts"] = idx
        # an edge grid's EF rows in the mesh's blocks are saved whole
        arrays["ef"] = {str(ci): {k: unshard(v, server.device) for k, v in
                                  server.cohorts[ci].ef_buffer.items()}
                        for ci in idx}
        if kind != "AsyncFLServer":
            step = server.step
        else:
            step = server.version
            arrays["versions"] = {str(v): t
                                  for v, t in server._versions.items()}
            sched = server._sched
            meta["async"] = {
                "version": server.version,
                "versions": sorted(server._versions),
                "refs": {str(v): n for v, n in server._refs.items()},
                # the heap list as stored satisfies the heap invariant;
                # JSON keeps list order and float64 bits
                "heap": [[t, s, c, v] for (t, s, c, v) in sched._heap],
                "seq": sched._seq,
                "dispatches": list(sched._dispatches),
            }
    meta["step"] = step

    os.makedirs(directory, exist_ok=True)
    npz = _path(directory, step, "npz")
    save_pytree(arrays, npz)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, _path(directory, step, "json"))
    for s in (_steps(directory)[:-keep] if keep else []):
        for ext in ("json", "npz"):
            try:
                os.remove(_path(directory, s, ext))
            except FileNotFoundError:
                pass
    return npz


def restore_run_state(server, directory: str, *, scenario=None,
                      step: int | None = None) -> int:
    """Load the checkpoint at ``step`` (default: the latest) from
    ``directory`` into ``server`` (freshly built, same kind, same
    scenario) and return the restored step. Raises on a missing
    checkpoint, another server kind, or another scenario."""
    if step is None:
        step = latest_run_step(directory)
        if step is None:
            raise FileNotFoundError(f"no run checkpoints in {directory!r}")
    with open(_path(directory, step, "json")) as f:
        meta = json.load(f)
    if meta["schema"] != _SCHEMA:
        raise ValueError(f"unknown checkpoint schema {meta['schema']}")
    kind = type(server).__name__
    if meta["server"] != kind:
        raise ValueError(f"checkpoint was written by {meta['server']}, "
                         f"cannot restore into {kind}")
    if (scenario is not None and meta["scenario"] is not None
            and meta["scenario"] != scenario.to_dict()):
        raise ValueError(
            "scenario mismatch: the checkpoint was written under a "
            "different FLScenario spec — resuming would silently diverge "
            "from both trajectories")

    tmpl = {"params": server.params, "opt_state": server.opt_state}
    if kind == "FLServer":
        tmpl["client_ef"] = {
            str(i): {k: torch.zeros_like(p) for k, p in server.params.items()}
            for i in meta["ef_clients"]}
    else:
        tmpl["ef"] = {str(ci): _cohort_ef_template(server, ci)
                      for ci in meta["ef_cohorts"]}
        if kind == "AsyncFLServer":
            tmpl["versions"] = {str(v): server.params
                                for v in meta["async"]["versions"]}

    loaded = load_pytree(tmpl, _path(directory, step, "npz"))
    server.params = loaded["params"]
    server.opt_state = loaded["opt_state"]
    server.history = [dict(r) for r in meta["history"]]
    if kind == "FLServer":
        for i in meta["ef_clients"]:
            server.clients[i].ef_buffer = loaded["client_ef"][str(i)]
        server.step = meta["step"]
        return meta["step"]
    mesh = getattr(server, "mesh", None)
    for ci in meta["ef_cohorts"]:
        ef = loaded["ef"][str(ci)]
        if mesh is not None and isinstance(server.cohorts[ci], EdgeCohort):
            ef = {k: edge_sharding(mesh).put(v) for k, v in ef.items()}
        server.cohorts[ci].ef_buffer = ef
    if kind != "AsyncFLServer":
        server.step = meta["step"]
        return meta["step"]
    a = meta["async"]
    server.version = a["version"]
    server._versions = {int(v): loaded["versions"][str(v)]
                        for v in a["versions"]}
    server._refs = {int(k): n for k, n in a["refs"].items()}
    sched = server._sched
    sched.version = a["version"]
    sched._seq = a["seq"]
    sched._dispatches = list(a["dispatches"])
    sched._heap = [(float(t), int(s), int(c), int(v))
                   for t, s, c, v in a["heap"]]
    return meta["step"]
