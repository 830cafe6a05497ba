"""Multi-round engine: run chunks of R federated rounds with the
participation and deadline masks precomputed on the host and every
per-round metric kept on the device, so a chunk costs ONE device -> host
sync instead of one per round.

- Participation replays the eager path's ``default_rng([seed, step])``
  sampling and its float64 ``T > deadline`` comparison on the host
  (:meth:`ScanEngine._host_masks`), so who participates is identical to
  the eager path by construction; the chunk's masks go to the device in
  one copy per cohort.
- Each round runs every cohort's step (a cohort nobody joined adds exact
  zeros), then the aggregation, then the server update — skipped, by a
  host-side check, in a round nobody joined.
- Loss sum, Eq. (1) wall-clock (a masked max) and upload bytes are f32
  on the device, as in the reference's compiled engine: those two record
  fields carry f32 rounding against the eager path's float64.

Aggregation backends (``agg``; the one actually used is ``agg_backend``):

- ``"sequential"``: the eager accumulate/scatter -> finalize chain.
- ``"pallas"`` (the reference's name; in the port, the hand-written CUDA
  kernel): ONE ``fleet_aggregate`` launch aggregates every leaf of the
  round (per 16 leaves), reading each cohort's update and mask where
  they lie; a masked tier covers the whole leaf, a width-sliced tier the
  prefix block of its slice. Reported ``"pallas"``, or
  ``"pallas_structured"`` for fleets with a real width slice (the
  reference's names for its two kernels). The kernel folds the tiers in
  cohort order with the chain's exact arithmetic, so the fused backend
  is bitwise the sequential one.

:class:`WindowScanEngine` is the async counterpart: chunks of
``AsyncFLServer`` windows, host-materialized, one sync per chunk.

The aggregation launch copies nothing host -> device, so it can be
captured in a CUDA graph; capturing a chunk is later speed work
(ROADMAP).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.aggregation import (f32, finalize, scatter_accumulate,
                                          zeros_like_acc)
from repro_torch.core.federated import (AsyncFLServer, CohortFLServer,
                                        _apply_fns, _cohort_upload,
                                        _init_cohort_ef, _local_param_struct,
                                        cohort_step_fn, window_groups)
from repro_torch.core.schedule import materialize_windows

AGG_BACKENDS = ("sequential", "pallas")


@dataclass
class ScanEngine:
    """Runs chunks of ``CohortFLServer`` rounds. The server stays the
    source of truth: the engine advances its ``params`` / ``opt_state`` /
    ``step`` / EF buffers and appends eager-schema records to its
    ``history``. ``chunk_rounds=0`` runs the whole request as one chunk."""
    server: CohortFLServer
    chunk_rounds: int = 0
    agg: str = "sequential"

    def __post_init__(self):
        if not isinstance(self.server, CohortFLServer):
            raise TypeError(f"{type(self.server).__name__} is not a "
                            "CohortFLServer; the engine runs cohort rounds only")
        if self.agg not in AGG_BACKENDS:
            raise ValueError(f"agg must be one of {AGG_BACKENDS}, got {self.agg!r}")
        if self.chunk_rounds < 0:
            raise ValueError("chunk_rounds must be >= 0 (0 = one chunk per run)")
        srv = self.server
        self._steps = [cohort_step_fn(srv.model.loss_fn, c.plan, srv.mode,
                                      srv.local_steps, srv.local_lr,
                                      srv.upload_quant)
                       for c in srv.cohorts]
        self._specs = [srv.cohort_spec(ci) for ci in range(len(srv.cohorts))]
        self._local_structs = [_local_param_struct(srv.params, c.plan)
                               for c in srv.cohorts]
        # only REAL slices route agg="pallas" to the prefix-block kernel;
        # a width=1.0 fleet has identity specs and takes the masked path
        self._any_sliced = any(s is not None and not s.is_identity
                               for s in self._specs)
        self._times = [srv.cohort_times(ci, c.data["x"].shape[1])
                       for ci, c in enumerate(srv.cohorts)]
        dev = srv.device
        self._T_dev = [torch.as_tensor(t["T"], dtype=torch.float32).to(dev)
                       for t in self._times]
        self._payload_dev = [torch.as_tensor(t["payload_bytes"],
                                             dtype=torch.float32).to(dev)
                             for t in self._times]
        self._apply = _apply_fns(srv.optimizer, srv.mode, srv.server_lr)

    @property
    def agg_backend(self) -> str:
        if self.agg != "pallas":
            return "sequential"
        return "pallas_structured" if self._any_sliced else "pallas"

    # ------------------------------------------------------- aggregation

    def _aggregate_sequential(self, params, per_cohort):
        acc = zeros_like_acc(params, dense_den=self.server.any_structured)
        for ci, (g_sum, masks, weight, count) in enumerate(per_cohort):
            acc = scatter_accumulate(acc, g_sum, masks, self._specs[ci],
                                     weight, count)
        return finalize(acc)

    def _aggregate_fused(self, params, per_cohort):
        """Every leaf of the round in one ``fleet_aggregate`` call (one
        launch per ``MAX_LEAVES`` leaves): each cohort's update and mask
        read in place, masked tiers covering the whole leaf, width-sliced
        tiers their prefix block. Denominator weights are ``w·n_part``,
        rounded one multiply early like the chain's."""
        from repro_torch.kernels.fleet_aggregate import fleet_aggregate
        wn = [f32(w) for (_, _, w, _) in per_cohort]
        wd = [f32(f32(w) * f32(c)) for (_, _, w, c) in per_cohort]
        return fleet_aggregate(
            {k: (p.shape, [(g[k], m[k]) for (g, m, _, _) in per_cohort])
             for k, p in params.items()}, wn, wd)

    # ------------------------------------------------------------ rounds

    def _round(self, r: int, xs: dict, efs: list):
        """One round on the device; returns its (loss_sum, wall,
        upload_bytes) device scalars."""
        srv = self.server
        params = srv.params
        per_cohort = []
        loss_sum = torch.zeros((), dtype=torch.float32, device=srv.device)
        wall = torch.full((), -np.inf, dtype=torch.float32, device=srv.device)
        up_bytes = torch.zeros((), dtype=torch.float32, device=srv.device)
        for ci, step in enumerate(self._steps):
            part = xs["part"][ci][r]
            ef = efs[ci]
            if srv.upload_quant is not None and not srv.error_feedback:
                ef = _init_cohort_ef(srv.cohorts[ci].size,
                                     self._local_structs[ci])
            g_sum, masks, l_sum, new_ef = step(params, srv.cohorts[ci].data,
                                               part, ef)
            if srv.error_feedback:
                efs[ci] = new_ef
            per_cohort.append((g_sum, masks, srv.cohorts[ci].plan.weight,
                               xs["count"][r][ci]))
            loss_sum = loss_sum + l_sum
            wall = torch.maximum(wall, torch.max(
                torch.where(part > 0, self._T_dev[ci], -np.inf)))
            up_bytes = up_bytes + torch.dot(part, self._payload_dev[ci])
        if xs["has"][r]:
            agg = (self._aggregate_fused(params, per_cohort)
                   if self.agg == "pallas"
                   else self._aggregate_sequential(params, per_cohort))
            srv.params, srv.opt_state = self._apply(
                agg, srv.opt_state, params, xs["step"][r])
        return loss_sum, wall, up_bytes

    def _host_masks(self, R: int):
        """The chunk's participation, replaying the eager round's
        sampling and float64 deadline drop on the host. Returns per-round
        lists of per-cohort bool masks and per-round drop counts."""
        srv = self.server
        parts, dropped = [], []
        for r in range(R):
            rng = np.random.default_rng([srv.seed, srv.step + r])
            sampled = srv._sample_participation(rng)
            n_dropped = 0
            cur = []
            for ci in range(len(srv.cohorts)):
                part = np.asarray(sampled[ci], bool).copy()
                if srv.straggler == "drop":
                    late = self._times[ci]["T"] > srv.deadline
                    n_dropped += int(np.sum(part & late))
                    part &= ~late
                cur.append(part)
            parts.append(cur)
            dropped.append(n_dropped)
        return parts, dropped

    def _ef_state(self) -> list:
        srv = self.server
        if srv.upload_quant is None:
            return [{} for _ in srv.cohorts]
        return [c.ef_buffer if (c.ef_buffer is not None and srv.error_feedback)
                else _init_cohort_ef(c.size, self._local_structs[ci])
                for ci, c in enumerate(srv.cohorts)]

    def _run_chunk(self, R: int) -> list[dict]:
        srv = self.server
        step0 = srv.step
        parts, dropped = self._host_masks(R)
        xs = {
            "step": list(range(step0, step0 + R)),
            "has": [any(p.any() for p in parts[r]) for r in range(R)],
            "count": [[float(p.sum()) for p in parts[r]] for r in range(R)],
            # one host -> device copy per cohort for the whole chunk
            "part": [torch.as_tensor(np.stack([parts[r][ci] for r in range(R)]),
                                     dtype=torch.float32).to(srv.device)
                     for ci in range(len(srv.cohorts))],
        }
        efs = self._ef_state()
        metrics = [self._round(r, xs, efs) for r in range(R)]
        srv.step = step0 + R
        if srv.upload_quant is not None and srv.error_feedback:
            for c, ef in zip(srv.cohorts, efs):
                c.ef_buffer = ef
        # the chunk's single device -> host sync
        m = torch.stack([torch.stack(x) for x in metrics]).cpu().numpy()
        recs = []
        for r in range(R):
            n_p = int(sum(p.sum() for p in parts[r]))
            wall = float(m[r, 1])
            rec = {
                "step": step0 + r + 1,
                "loss": float(m[r, 0]) / n_p if n_p else None,
                "n_participants": n_p,
                "n_dropped": dropped[r],
                "round_wall_time": (
                    srv.deadline if srv.straggler == "drop" and dropped[r]
                    else (wall if np.isfinite(wall) else 0.0)),
                "total_upload_bytes": float(m[r, 2]),
            }
            srv.history.append(rec)
            recs.append(rec)
        return recs

    def run(self, rounds: int) -> list[dict]:
        """Advance the server ``rounds`` rounds in chunks of
        ``chunk_rounds`` (0 = one chunk); returns the new records."""
        if rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {rounds}")
        chunk = self.chunk_rounds or rounds
        recs, done = [], 0
        while done < rounds:
            r = min(chunk, rounds - done)
            recs += self._run_chunk(r)
            done += r
        return recs


@dataclass
class WindowScanEngine:
    """Runs chunks of ``AsyncFLServer`` aggregation windows. The
    virtual-clock schedule is deterministic, so a chunk's windows are
    host-materialized up front (``schedule.materialize_windows``): the
    (cohort, version) groups of every window (:func:`window_groups`),
    their participation masks (one host -> device copy per cohort per
    chunk), counts and staleness discounts (the eager step's float64
    expression). The version store is a ring of ``capacity`` parameter
    copies on the device, version ``v`` at slot ``v % capacity`` with the
    capacity above the largest version lag the chunk reads or leaves in
    flight; each window's loss sum stays on the device and the chunk
    syncs once. Each group runs the eager step's own cohort dispatch and
    accumulation in the same order, so the engine is bitwise the eager
    ``step()`` (SGD, momentum; Adam too, tested to 1e-6).

    The server stays the source of truth: after a run the engine writes
    back ``params`` / ``opt_state`` / ``version`` / the refcounted
    version store / EF buffers, advances the heap scheduler to match and
    appends eager-schema records to ``history``, so engine windows and
    eager ``step()`` calls interleave.

    The reference's compiled engine also needs optimization barriers,
    runtime mask-ones and padded group slots gated by ``lax.cond`` to
    keep XLA's fusion from reordering its arithmetic; eager PyTorch runs
    each op as written, so none of them has a counterpart here. It always
    aggregates through the sequential chain (``agg_backend``): a window's
    groups arrive one (cohort, version) at a time, with no tier axis to
    fuse.
    """
    server: AsyncFLServer
    chunk_windows: int = 0

    def __post_init__(self):
        if not isinstance(self.server, AsyncFLServer):
            raise TypeError(
                f"{type(self.server).__name__} is not the async buffered "
                "runtime; the window engine runs AsyncFLServer windows only "
                "(use ScanEngine for CohortFLServer rounds)")
        if self.chunk_windows < 0:
            raise ValueError(
                "chunk_windows must be >= 0 (0 = one chunk per run)")
        self.chunks_run = 0
        self.windows_run = 0
        self._cap = 1
        srv = self.server
        self._apply = _apply_fns(srv.optimizer, srv.mode, srv.server_lr)

    @property
    def agg_backend(self) -> str:
        return "sequential"

    def _ring_init(self) -> dict:
        """Every live version's params at slot ``version % capacity``."""
        srv = self.server
        ring = {k: torch.zeros((self._cap,) + tuple(p.shape), dtype=p.dtype,
                               device=p.device)
                for k, p in srv.params.items()}
        for v, pv in srv._versions.items():
            for k, r in ring.items():
                r[v % self._cap].copy_(pv[k])
        return ring

    def _window(self, version: int, groups, parts, ring) -> torch.Tensor:
        """The window applied at ``version``, on the device; returns its
        loss sum."""
        srv = self.server
        acc = zeros_like_acc(srv.params, dense_den=srv.any_structured)
        loss_sum = torch.zeros((), dtype=torch.float32, device=srv.device)
        for g, ((ci, v), rows) in enumerate(groups):
            pv = {k: r[v % self._cap] for k, r in ring.items()}
            g_sum, masks, l_sum = _cohort_upload(srv, srv.cohorts[ci],
                                                 parts[g], pv)
            acc = scatter_accumulate(
                acc, g_sum, masks, srv.cohort_spec(ci),
                srv.cohorts[ci].plan.weight, len(rows),
                staleness_weight=srv.discount(version - v))
            loss_sum = loss_sum + l_sum
        cur = {k: r[version % self._cap] for k, r in ring.items()}
        new_params, srv.opt_state = self._apply(finalize(acc), srv.opt_state,
                                                cur, version)
        # the new version goes over the slot no reader can reach any more
        for k, r in ring.items():
            r[(version + 1) % self._cap].copy_(new_params[k])
        return loss_sum

    def _run_chunk(self, W: int) -> list[dict]:
        srv = self.server
        plan = materialize_windows(srv._sched, W)
        init_lag = srv.version - min(srv._versions)
        self._cap = max(self._cap, plan.max_version_lag + 1, init_lag + 1)
        groups = [window_groups(srv._slots, plan.client[w],
                                plan.upload_version[w]) for w in range(W)]
        # every group's participation mask, one host -> device copy per
        # cohort for the whole chunk; parts[w][g] is group g's device row
        host = [[] for _ in srv.cohorts]
        where = []
        for gs in groups:
            where.append([])
            for (ci, _), rows in gs:
                m = np.zeros(srv.cohorts[ci].size, np.float32)
                m[rows] = 1.0
                where[-1].append((ci, len(host[ci])))
                host[ci].append(m)
        dev = [torch.from_numpy(np.stack(h)).to(srv.device) if h else None
               for h in host]
        parts = [[dev[ci][i] for ci, i in ws] for ws in where]

        ring = self._ring_init()
        losses = [self._window(plan.version0 + w, groups[w], parts[w], ring)
                  for w in range(W)]
        # the chunk's single device -> host sync
        loss_host = torch.stack(losses).cpu().tolist()
        K = plan.buffer_size
        recs = []
        for w in range(W):
            stale = plan.staleness[w]
            rec = {"step": plan.version0 + w + 1, "t": float(plan.t[w]),
                   "loss": loss_host[w] / K, "n_updates": K,
                   "staleness_mean": float(np.mean(stale)),
                   "staleness_max": int(stale.max()),
                   "n_versions_live": int(plan.n_versions_live[w]),
                   "total_upload_bytes": sum(srv._payload_bytes[int(c)]
                                             for c in plan.client[w])}
            srv.history.append(rec)
            recs.append(rec)

        # write the advanced state back so eager step()s continue from it
        v_end = plan.version0 + W
        srv.params = {k: r[v_end % self._cap].clone() for k, r in ring.items()}
        srv.version = v_end
        uniq, counts = np.unique(plan.end_version, return_counts=True)
        srv._versions = {int(v): (srv.params if int(v) == v_end else
                                  {k: r[int(v) % self._cap].clone()
                                   for k, r in ring.items()})
                         for v in uniq}
        srv._refs = {int(v): int(c) for v, c in zip(uniq, counts)}
        srv._sched.trace(W)                 # advance the heap to match
        self.chunks_run += 1
        return recs

    def run(self, n_windows: int) -> list[dict]:
        """Advance the server ``n_windows`` windows in chunks of
        ``chunk_windows`` (0 = one chunk); returns the new records."""
        if n_windows < 1:
            raise ValueError(f"n_windows must be >= 1, got {n_windows}")
        chunk = self.chunk_windows or n_windows
        recs, done = [], 0
        while done < n_windows:
            w = min(chunk, n_windows - done)
            recs += self._run_chunk(w)
            done += w
        self.windows_run += n_windows
        return recs


def simulate_rounds(server, rounds: int, *, chunk_rounds: int = 0,
                    agg: str = "sequential") -> list[dict]:
    """Run ``rounds`` on ``server`` through a fresh :class:`ScanEngine`
    (cohort runtime) or :class:`WindowScanEngine` (async runtime); the
    per-client runtime runs eager ``round()`` calls. Returns the new
    records."""
    if isinstance(server, AsyncFLServer):
        return WindowScanEngine(server, chunk_windows=chunk_rounds).run(rounds)
    if not isinstance(server, CohortFLServer):
        return [server.round() for _ in range(rounds)]
    return ScanEngine(server, chunk_rounds=chunk_rounds, agg=agg).run(rounds)
