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
- Under a :class:`~repro_torch.core.faults.FaultPolicy` the host replay
  also applies availability, dropouts and corruption in the eager
  round's order (:meth:`ScanEngine._host_masks`); the wall-clock maxes
  over who ran (crashed clients included), the rest over who uploaded.
  A policy that touches uploads swaps each cohort's step for its fault
  twin and aggregates with per-coordinate coverage, which the fused
  kernel has no column for: it runs ``agg="sequential"`` only.
- Topology fleets (every cohort an
  :class:`~repro_torch.core.topology.EdgeCohort`): each cohort runs the
  eager round's edge step (``federated.edge_step_fn``) on its block(s) of
  the grid and the hub chains the per-edge partials in edge order
  (``federated._hub_combine``), the loss partial of each edge after its
  update, as the eager round does; a cohort nobody joined adds exact
  zeros. The chunk's ``(E, R, cap)`` participation grids go to the device
  once per chunk (once per block under a mesh); the per-edge counts stay
  host floats, as every count of the port's aggregation does. The
  records' wall-clock and bytes are computed on the host in float64 with
  the eager round's expressions, so topology records equal the eager
  ones exactly. The fused kernel has no edge axis: ``agg="sequential"``
  only, as in the reference.

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

import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.aggregation import (f32, finalize, scatter_accumulate,
                                          zeros_like_acc)
from repro_torch.core.faults import (availability_mask, corrupt_mask,
                                     corrupt_seq_mask, dropout_mask)
from repro_torch.core.federated import (AsyncFLServer, CohortFLServer,
                                        _apply_fns, _cohort_upload,
                                        _edge_ef, _edge_upload,
                                        _fault_cohort_upload,
                                        _guard_cov_active, _hub_combine,
                                        _init_cohort_ef,
                                        _local_param_struct, _n_batch,
                                        _place_edges, cohort_step_fn,
                                        edge_step_fn, fault_cohort_step_fn,
                                        window_groups)
from repro_torch.core.schedule import materialize_windows
from repro_torch.core.topology import EdgeCohort, scatter_part

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
        self._topology = (len(srv.cohorts) > 0
                          and isinstance(srv.cohorts[0], EdgeCohort))
        if self._topology and self.agg != "sequential":
            raise ValueError(
                "topology fleets aggregate per (plan, edge) partial — "
                "the fused pallas backends have no edge axis; use "
                "agg='sequential'")
        self._fault_uploads = (srv.faults is not None
                               and srv.faults.touches_uploads)
        if self._fault_uploads and self.agg != "sequential":
            raise ValueError(
                "upload corruption/defenses aggregate with per-coordinate "
                "coverage denominators — the fused fleet_aggregate kernel "
                "has no coverage column; use agg='sequential'")
        step_fn = (edge_step_fn if self._topology else
                   functools.partial(fault_cohort_step_fn, faults=srv.faults)
                   if self._fault_uploads else cohort_step_fn)
        self._steps = [step_fn(srv.model.loss_fn, c.plan, srv.mode,
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
        self._times = [srv.cohort_times(ci, _n_batch(c))
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

    def _aggregate_sequential(self, params, per_cohort, covs=None):
        """The eager round's accumulate/scatter -> finalize chain;
        ``covs`` holds each cohort's fault coverage (or None)."""
        srv = self.server
        acc = zeros_like_acc(params, dense_den=(
            srv.any_structured or _guard_cov_active(srv.faults)))
        for ci, (g_sum, masks, weight, count) in enumerate(per_cohort):
            acc = scatter_accumulate(acc, g_sum, masks, self._specs[ci],
                                     weight, count,
                                     cov=None if covs is None else covs[ci])
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
        per_cohort, covs = [], []
        loss_sum = torch.zeros((), dtype=torch.float32, device=srv.device)
        wall = torch.full((), -np.inf, dtype=torch.float32, device=srv.device)
        up_bytes = torch.zeros((), dtype=torch.float32, device=srv.device)
        for ci, step in enumerate(self._steps):
            part = xs["part"][ci][r]
            ef = efs[ci]
            if srv.upload_quant is not None and not srv.error_feedback:
                ef = _init_cohort_ef(srv.cohorts[ci].size,
                                     self._local_structs[ci])
            if self._fault_uploads:
                g_sum, masks, cov, l_sum, new_ef = step(
                    params, srv.cohorts[ci].data, part, ef,
                    xs["corrupt"][ci][r], xs["uid"][ci][r])
            else:
                cov = None
                g_sum, masks, l_sum, new_ef = step(
                    params, srv.cohorts[ci].data, part, ef)
            if srv.error_feedback:
                efs[ci] = new_ef
            per_cohort.append((g_sum, masks, srv.cohorts[ci].plan.weight,
                               xs["count"][r][ci]))
            covs.append(cov)
            loss_sum = loss_sum + l_sum
            # crashed clients burn wall-clock but upload nothing
            wp = xs["wpart"][ci][r] if "wpart" in xs else part
            wall = torch.maximum(wall, torch.max(
                torch.where(wp > 0, self._T_dev[ci], -np.inf)))
            up_bytes = up_bytes + torch.dot(part, self._payload_dev[ci])
        if xs["has"][r]:
            agg = (self._aggregate_fused(params, per_cohort)
                   if self.agg == "pallas"
                   else self._aggregate_sequential(params, per_cohort, covs))
            srv.params, srv.opt_state = self._apply(
                agg, srv.opt_state, params, xs["step"][r])
        return loss_sum, wall, up_bytes

    def _grid_round(self, r: int, xs: dict, efs: list) -> torch.Tensor:
        """One topology round on the device: each cohort's edge step on
        its blocks, the hub's fixed-order combine; returns the loss
        sum."""
        srv = self.server
        params = srv.params
        acc = zeros_like_acc(params, dense_den=srv.any_structured)
        loss_sum = torch.zeros((), dtype=torch.float32, device=srv.device)
        for ci, (cohort, step) in enumerate(zip(srv.cohorts, self._steps)):
            ef = efs[ci]
            if srv.upload_quant is not None and not srv.error_feedback:
                ef = _edge_ef(srv, cohort, params)
            g_sums, masks, l_sums, new_ef = _edge_upload(
                srv, cohort, step, params,
                [blk[:, r] for blk in xs["part"][ci]], ef)
            if srv.error_feedback:
                efs[ci] = new_ef
            acc, loss_sum = _hub_combine(acc, loss_sum, g_sums, masks, l_sums,
                                         self._specs[ci], cohort.plan.weight,
                                         xs["count"][r][ci])
        if xs["has"][r]:
            srv.params, srv.opt_state = self._apply(
                finalize(acc), srv.opt_state, params, xs["step"][r])
        return loss_sum

    def _host_masks(self, R: int, participation=None):
        """The chunk's participation, replaying the eager round on the
        host in its order: sampling (or the round's pinned per-cohort
        masks from ``participation``), availability, the float64 deadline
        drop, mid-round crashes. Returns per-round lists of per-cohort
        bool masks: who uploads, who ran (burns wall-clock) and whose
        upload is corrupted (active rows only); and per-round deadline
        drop and crash counts."""
        srv = self.server
        flt = srv.faults
        n_total = srv.n_clients
        parts, wparts, corrs, dropped, dropouts = [], [], [], [], []
        for r in range(R):
            step = srv.step + r
            sampled = (srv._sample_participation(
                np.random.default_rng([srv.seed, step]))
                if participation is None
                else [np.asarray(p, bool) for p in participation[r]])
            if flt is not None:
                avail = availability_mask(flt, n_total, step)
                drops = dropout_mask(flt, n_total, step)
                corr = corrupt_mask(flt, n_total, step)
            n_dropped = n_do = 0
            cur, curw, curc = [], [], []
            off = 0
            for ci in range(len(srv.cohorts)):
                off0, off = off, off + srv.cohorts[ci].size
                part = np.asarray(sampled[ci], bool).copy()
                if flt is not None:
                    part &= avail[off0:off]
                if srv.straggler == "drop":
                    late = self._times[ci]["T"] > srv.deadline
                    n_dropped += int(np.sum(part & late))
                    part &= ~late
                active = part
                if flt is not None and flt.dropout_rate > 0.0:
                    crashed = part & drops[off0:off]
                    n_do += int(crashed.sum())
                    active = part & ~crashed
                curw.append(part)
                cur.append(active)
                curc.append(corr[off0:off] & active if self._fault_uploads
                            else None)
            parts.append(cur)
            wparts.append(curw)
            corrs.append(curc)
            dropped.append(n_dropped)
            dropouts.append(n_do)
        return parts, wparts, corrs, dropped, dropouts

    def _ef_state(self) -> list:
        srv = self.server
        if srv.upload_quant is None:
            return [{} for _ in srv.cohorts]
        if self._topology:
            return [_edge_ef(srv, c, srv.params) for c in srv.cohorts]
        return [c.ef_buffer if (c.ef_buffer is not None and srv.error_feedback)
                else _init_cohort_ef(c.size, self._local_structs[ci])
                for ci, c in enumerate(srv.cohorts)]

    def _run_chunk(self, R: int, participation=None) -> list[dict]:
        srv = self.server
        step0 = srv.step
        parts, wparts, corrs, dropped, dropouts = self._host_masks(
            R, participation)
        C = len(srv.cohorts)

        def per_cohort(rows, dtype):
            # one host -> device copy per cohort for the whole chunk
            return [torch.as_tensor(np.stack([rows[r][ci] for r in range(R)]),
                                    dtype=dtype).to(srv.device)
                    for ci in range(C)]
        xs = {
            "step": list(range(step0, step0 + R)),
            "has": [any(p.any() for p in parts[r]) for r in range(R)],
        }
        if self._topology:
            return self._run_grid_chunk(R, xs, parts, wparts, dropped,
                                        dropouts)
        xs["count"] = [[float(p.sum()) for p in parts[r]] for r in range(R)]
        xs["part"] = per_cohort(parts, torch.float32)
        if srv.faults is not None:
            xs["wpart"] = per_cohort(wparts, torch.float32)
        if self._fault_uploads:
            xs["corrupt"] = per_cohort(corrs, torch.float32)
            # uid = step * n_clients + flat client index, the eager key
            offs = np.cumsum([0] + [c.size for c in srv.cohorts])
            xs["uid"] = per_cohort(
                [[(step0 + r) * srv.n_clients + np.arange(offs[ci],
                                                          offs[ci + 1])
                  for ci in range(C)] for r in range(R)], torch.int64)
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
            if srv.faults is not None:
                rec["n_dropouts"] = dropouts[r]
                rec["n_corrupt"] = (int(sum(c.sum() for c in corrs[r]))
                                    if self._fault_uploads else 0)
            srv.history.append(rec)
            recs.append(rec)
        return recs

    def _run_grid_chunk(self, R: int, xs: dict, parts, wparts, dropped,
                        dropouts) -> list[dict]:
        """A topology chunk: the ``(E, R, cap)`` participation grid of each
        cohort placed once (in the mesh's blocks), the per-edge counts on
        the host, the rounds, one sync; records on the host in float64
        with the eager round's expressions."""
        srv = self.server
        step0 = srv.step
        # (E, R, cap): the edge axis leads, so the blocks split it
        xs["part"] = [_place_edges(srv, torch.from_numpy(np.stack(
            [scatter_part(c, parts[r][ci]) for r in range(R)], axis=1)))
            for ci, c in enumerate(srv.cohorts)]
        xs["count"] = [[np.bincount(c.edge_index[parts[r][ci]],
                                    minlength=c.n_edges)
                        for ci, c in enumerate(srv.cohorts)]
                       for r in range(R)]
        efs = self._ef_state()
        losses = [self._grid_round(r, xs, efs) for r in range(R)]
        srv.step = step0 + R
        if srv.upload_quant is not None and srv.error_feedback:
            for c, ef in zip(srv.cohorts, efs):
                c.ef_buffer = ef
        # the chunk's single device -> host sync
        loss_host = torch.stack(losses).cpu().numpy()
        recs = []
        for r in range(R):
            n_p, wall, up = 0, 0.0, 0.0
            for ci, p in enumerate(parts[r]):
                # who ran burns wall-clock, who uploaded is billed
                wp = wparts[r][ci]
                if wp.any():
                    wall = max(wall, float(self._times[ci]["T"][wp].max()))
                if p.any():
                    n_p += int(p.sum())
                    up += float(self._times[ci]["payload_bytes"][p].sum())
            rec = {
                "step": step0 + r + 1,
                "loss": float(loss_host[r]) / n_p if n_p else None,
                "n_participants": n_p,
                "n_dropped": dropped[r],
                "round_wall_time": (srv.deadline if srv.straggler == "drop"
                                    and dropped[r] else wall),
                "total_upload_bytes": up,
            }
            if srv.faults is not None:
                rec["n_dropouts"] = dropouts[r]
                rec["n_corrupt"] = 0
            srv.history.append(rec)
            recs.append(rec)
        return recs

    def run(self, rounds: int, participation=None) -> list[dict]:
        """Advance the server ``rounds`` rounds in chunks of
        ``chunk_rounds`` (0 = one chunk); returns the new records.
        ``participation`` (optional, tests): one list of per-cohort bool
        masks per round, overriding the sampled participation as
        ``CohortFLServer.round(participation=...)`` does."""
        if rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {rounds}")
        if participation is not None and len(participation) != rounds:
            raise ValueError(f"participation pins {len(participation)} "
                             f"rounds for a {rounds}-round run")
        chunk = self.chunk_rounds or rounds
        recs, done = [], 0
        while done < rounds:
            r = min(chunk, rounds - done)
            recs += self._run_chunk(
                r, None if participation is None
                else participation[done:done + r])
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

    def _window(self, version: int, groups, parts, ring,
                fault_rows=None) -> torch.Tensor:
        """The window applied at ``version``, on the device; returns its
        loss sum. ``fault_rows`` is the window's
        :meth:`AsyncFLServer.fault_rows` under upload faults."""
        srv = self.server
        acc = zeros_like_acc(srv.params, dense_den=(
            srv.any_structured or _guard_cov_active(srv.faults)))
        loss_sum = torch.zeros((), dtype=torch.float32, device=srv.device)
        for g, ((ci, v), rows) in enumerate(groups):
            pv = {k: r[v % self._cap] for k, r in ring.items()}
            cov = None
            if fault_rows is not None:
                flags, uid = fault_rows[ci]
                c_row = np.zeros_like(flags)
                c_row[rows] = flags[rows]
                g_sum, masks, cov, l_sum = _fault_cohort_upload(
                    srv, srv.cohorts[ci], parts[g], pv, c_row, uid)
            else:
                g_sum, masks, l_sum = _cohort_upload(srv, srv.cohorts[ci],
                                                     parts[g], pv)
            acc = scatter_accumulate(
                acc, g_sum, masks, srv.cohort_spec(ci),
                srv.cohorts[ci].plan.weight, len(rows),
                staleness_weight=srv.discount(version - v), cov=cov)
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

        flt = srv.faults
        fault_rows = ([srv.fault_rows(plan.client[w], plan.upload_seq[w])
                       for w in range(W)]
                      if flt is not None and flt.touches_uploads
                      else [None] * W)
        ring = self._ring_init()
        losses = [self._window(plan.version0 + w, groups[w], parts[w], ring,
                               fault_rows[w])
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
            if flt is not None:
                rec["n_corrupt"] = int(corrupt_seq_mask(
                    flt, plan.upload_seq[w]).sum())
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
