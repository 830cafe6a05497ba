"""The federated runtimes (paper Fig. 1):

  global model --compress(plan_c)--> local model on device c
  local model  --train on local data--> gradients (or deltas)
  gradients    --upload (optionally quantized, with error feedback)--> server
  server       --hetero-aggregate + optimizer step--> new global model

Two aggregation modes (paper §4.2): fedsgd (one local gradient per
round) and fedavg (``local_steps`` of compressed-space SGD, then the
parameter deltas). Beyond-paper: upload quantization with per-client
error feedback. Three runtimes share that loop:

- :class:`FLServer`, per client: one step and one aggregation entry per
  client, each on its own (ragged) shard; faithful and easy to
  instrument, O(#clients) launches.
- :class:`CohortFLServer`: clients sharing a ``CompressionPlan`` form a
  :class:`Cohort`; their data is stacked on a leading client axis and
  one step runs per cohort, with the client axis written out in the
  tensors (no Python loop over clients).
- :class:`AsyncFLServer`: a virtual clock (``core/schedule.py``) buffers
  uploads as their Eq. (1) finish times land; each buffered window
  aggregates staleness-discounted updates trained against whatever
  global version each client last downloaded, one cohort step per
  (cohort, version) group.

Fault policies are not ported: a runtime given one raises.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core._unported import not_ported
from repro_torch.core.aggregation import (finalize, hetero_aggregate,
                                          scatter_accumulate, zeros_like_acc)
from repro_torch.core.compression import (CompressionPlan, compress_params,
                                          expand_update, slice_tree,
                                          submodel_spec)
from repro_torch.core.compression.quantization import _quant
from repro_torch.core.heterogeneity import (PROFILES, cohort_round_time,
                                            round_time)
from repro_torch.core.schedule import VirtualClockScheduler
from repro_torch.data.federated import stack_shards
from repro_torch.numerics import FORMATS


@dataclass
class Client:
    id: int
    plan: CompressionPlan
    data: dict                      # {"x": (n, F), "y": (n,)} host tensors
    profile_name: str = "mid"
    ef_buffer: Any = None           # per-client EF residual (FLServer)


@dataclass
class Cohort:
    """Clients sharing one CompressionPlan: ``data`` leaves carry a
    leading client axis ``(C, n, ...)`` on the device; ``ef_buffer``
    (upload quantization + error feedback) holds per-client residuals
    stacked the same way, kept across rounds a client sits out."""
    plan: CompressionPlan
    client_ids: tuple[int, ...]
    data: dict
    profile_names: tuple[str, ...]
    ef_buffer: Any = None

    @property
    def size(self) -> int:
        return len(self.client_ids)


def build_cohorts(clients: list[Client], device) -> list[Cohort]:
    """Group clients by plan (first-appearance order; client order kept
    within a cohort) and stack their shards onto ``device``."""
    groups: dict[CompressionPlan, list[Client]] = {}
    for c in clients:
        groups.setdefault(c.plan, []).append(c)
    return [Cohort(plan=plan,
                   client_ids=tuple(c.id for c in cs),
                   data=stack_shards([c.data for c in cs], device),
                   profile_names=tuple(c.profile_name for c in cs))
            for plan, cs in groups.items()]


def _local_param_struct(params: dict, plan: CompressionPlan) -> dict:
    """The LOCAL model a plan trains (the width-sliced views for
    structured plans): what EF buffers are allocated against."""
    if not plan.structured:
        return params
    return slice_tree(params, submodel_spec(params, plan.width))


def _init_cohort_ef(size: int, params: dict) -> dict:
    """Zero residuals, one row per client, in each leaf's dtype."""
    return {k: torch.zeros((size,) + tuple(p.shape), dtype=p.dtype,
                           device=p.device) for k, p in params.items()}


def _quantize_clients(updates: dict, part: torch.Tensor, ef: dict,
                      fmt: str | None):
    """Client-side upload quantization of per-client updates ``(C, ...)``
    with stacked error feedback; non-participants keep their residual."""
    if fmt is None:
        return updates, ef
    f = FORMATS[fmt]
    corrected = {k: u + ef[k] for k, u in updates.items()}
    q = {k: _quant(c, f.e_bits, f.m_bits) for k, c in corrected.items()}
    new_ef = {}
    for k, c in corrected.items():
        keep = part.reshape((-1,) + (1,) * (c.dim() - 1)) > 0
        new_ef[k] = torch.where(keep, c - q[k], ef[k]).to(ef[k].dtype)
    return q, new_ef


def _upload_and_sum(updates: dict, part: torch.Tensor, ef: dict,
                    fmt: str | None):
    """Participation-masked upload: optional quantization with error
    feedback, then the weighted sum over the client axis."""
    updates, ef = _quantize_clients(updates, part, ef, fmt)
    return {k: torch.tensordot(part, u, dims=1)
            for k, u in updates.items()}, ef


def _leaf_copies(params: dict, n: int | None = None) -> dict:
    """Fresh autograd leaves: ``params`` detached, or ``n`` stacked
    copies of it on a new leading client axis."""
    if n is None:
        return {k: v.detach().clone().requires_grad_(True)
                for k, v in params.items()}
    return {k: v.detach().unsqueeze(0).expand((n,) + tuple(v.shape))
            .clone().requires_grad_(True) for k, v in params.items()}


def _grads(loss: torch.Tensor, leaves: dict) -> dict:
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _local_sgd(loss_fn: Callable, plan: CompressionPlan, local_steps: int,
               lr: float):
    """FedAvg local training IN COMPRESSED SPACE, w <- C(w - lr·g), for
    every client of a cohort at once: ``(cp0, batches) -> (last_losses,
    deltas)`` with a leading client axis. Re-compression after each step
    is per client (its own masks and codebooks). For structured plans
    ``cp0`` already lives at the sliced shapes and the re-compression
    uses the within-slice plan."""
    cplan = plan.inner()

    def run(cp0: dict, batches: dict):
        n = next(iter(batches.values())).shape[0]
        w = {k: v.detach() for k, v in _leaf_copies(cp0, n).items()}
        for _ in range(local_steps):
            with torch.enable_grad():
                w = {k: v.requires_grad_(True) for k, v in w.items()}
                losses = loss_fn(w, batches)
                g = _grads(losses.sum(), w)
            with torch.no_grad():
                w = {k: v - lr * g[k] for k, v in w.items()}
                w = compress_params(w, cplan, batch=1)[0]
        return losses.detach(), {k: v - cp0[k] for k, v in w.items()}
    return run


def cohort_step_fn(loss_fn: Callable, plan: CompressionPlan, mode: str,
                   local_steps: int, local_lr: float,
                   upload_fmt: str | None) -> Callable:
    """The one-cohort round step,
    ``(params, batches, part, ef) -> (update_sum, masks, loss_sum, ef)``.

    Three branches: fedsgd without upload quantization differentiates the
    participation-weighted loss SUM once (its gradient is the sum of the
    per-client gradients); fedsgd with upload quantization needs each
    client's gradient (the residuals are per client), so it
    differentiates per-client copies of the weights; fedavg runs
    :func:`_local_sgd` and uploads deltas. Structured plans slice the
    global params first and return SUB-shaped updates and masks.
    """
    inner = plan.inner()

    def _base(params):
        if not plan.structured:
            return params
        return slice_tree(params, submodel_spec(params, plan.width))

    if mode == "fedsgd" and upload_fmt is None:
        def f(params, batches, part, ef):
            with torch.enable_grad():
                p = _leaf_copies(_base(params))
                cp, masks = compress_params(p, inner)
                l_sum = torch.sum(part * loss_fn(cp, batches))
                g_sum = _grads(l_sum, p)
            return g_sum, masks, l_sum.detach(), ef
        return f

    if mode == "fedsgd":
        def f(params, batches, part, ef):
            p0 = _base(params)
            with torch.enable_grad():
                pc = _leaf_copies(p0, part.shape[0])
                cp, _ = compress_params(pc, inner, batch=1)
                losses = loss_fn(cp, batches)
                grads = _grads(losses.sum(), pc)
            with torch.no_grad():
                _, masks = compress_params(p0, inner)
            g_sum, ef = _upload_and_sum(grads, part, ef, upload_fmt)
            return g_sum, masks, torch.sum(part * losses.detach()), ef
        return f

    local = _local_sgd(loss_fn, plan, local_steps, local_lr)

    def f(params, batches, part, ef):
        with torch.no_grad():
            cp0, masks = compress_params(_base(params), inner)
        losses, deltas = local(cp0, batches)
        d_sum, ef = _upload_and_sum(deltas, part, ef, upload_fmt)
        return d_sum, masks, torch.sum(part * losses), ef
    return f


def _apply_fns(optimizer, mode: str, server_lr: float) -> Callable:
    """The server-side model update
    ``(agg, opt_state, params, step) -> (params, opt_state)``: fedavg
    applies the aggregated delta with the server lr, fedsgd feeds the
    aggregated gradient to the optimizer."""
    if mode == "fedavg":
        def f(agg, opt_state, params, step):
            return {k: p + server_lr * agg[k] for k, p in params.items()}, \
                opt_state
    else:
        def f(agg, opt_state, params, step):
            return optimizer.update(agg, opt_state, params, step=step)
    return f


# ------------------------------------------------- per-client runtime

@functools.lru_cache(maxsize=64)
def _client_grad_fn(loss_fn: Callable, plan: CompressionPlan) -> Callable:
    """One client's FedSGD step, ``(params, batch) -> (loss, grads,
    masks)``: the gradient of the plan-compressed model's loss with
    respect to the global params (straight through the compression).
    Cached per (loss_fn, plan)."""
    def f(params, batch):
        with torch.enable_grad():
            p = _leaf_copies(params)
            cp, masks = compress_params(p, plan)
            loss = loss_fn(cp, batch)
            grads = _grads(loss, p)
        return loss.detach(), grads, masks
    return f


@functools.lru_cache(maxsize=64)
def _client_local_train_fn(loss_fn: Callable, plan: CompressionPlan,
                           local_steps: int, lr: float) -> Callable:
    """One client's FedAvg round, ``(params, batch) -> (loss, delta,
    masks)``: :func:`_local_sgd` on a one-client axis. Structured plans
    train the sliced sub-model and their delta is zero-padded back to
    the global shapes (this runtime aggregates full-shape updates)."""
    local = _local_sgd(loss_fn, plan, local_steps, lr)

    def f(params, batch):
        with torch.no_grad():
            cp0, masks = compress_params(params, plan)
        losses, deltas = local(cp0, {k: v.unsqueeze(0)
                                     for k, v in batch.items()})
        delta = {k: d[0] for k, d in deltas.items()}
        if plan.structured:
            delta = expand_update(delta, submodel_spec(params, plan.width),
                                  params)
        return losses[0], delta, masks
    return f


def _maybe_quantize_upload(grads: dict, fmt: str | None, ef_buffer,
                           params: dict):
    """Upload quantization with error feedback for one client. Residuals
    live in the param dtype. Returns (uploaded, new_ef_buffer)."""
    if fmt is None:
        return grads, ef_buffer
    f = FORMATS[fmt]
    if ef_buffer is None:
        ef_buffer = {k: torch.zeros_like(p) for k, p in params.items()}
    corrected = {k: g + ef_buffer[k] for k, g in grads.items()}
    q = {k: _quant(c, f.e_bits, f.m_bits) for k, c in corrected.items()}
    new_ef = {k: (c - q[k]).to(ef_buffer[k].dtype)
              for k, c in corrected.items()}
    return q, new_ef


@dataclass
class FLServer:
    """The per-client runtime: every client trains on its own shard
    (ragged sizes allowed), and the round aggregates the clients' full-
    shape updates tier by tier (:func:`hetero_aggregate`). O(#clients)
    steps per round and one device -> host sync."""
    model: Any
    optimizer: Any
    clients: list[Client]
    params: dict
    opt_state: Any = None
    mode: str = "fedsgd"            # fedsgd | fedavg
    local_steps: int = 5
    local_lr: float = 0.1
    server_lr: float = 1.0
    upload_quant: str | None = None
    error_feedback: bool = False
    faults: Any = None
    step: int = 0
    history: list = field(default_factory=list)

    def __post_init__(self):
        if self.faults is not None:
            raise not_ported("a FaultPolicy on the per-client runtime",
                              "Faults")
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(self.params)
        # each client's shard on the params' device, once
        self._data = [{k: v.to(self.device) for k, v in c.data.items()}
                      for c in self.clients]

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def round(self, client_batches: list[dict] | None = None) -> dict:
        """One federated round; ``client_batches`` defaults to each
        client's full shard (the paper's batch gradient descent)."""
        loss_fn = self.model.loss_fn
        batches = (self._data if client_batches is None else
                   [{k: v.to(self.device) for k, v in b.items()}
                    for b in client_batches])
        grads_list, masks_list, weights, losses = [], [], [], []
        wall, upload_bytes = 0.0, 0.0
        for c, batch in zip(self.clients, batches):
            n_batch = next(iter(batch.values())).shape[0]
            comm = round_time(self.params, c.plan, PROFILES[c.profile_name],
                              n_batch,
                              self.local_steps if self.mode == "fedavg" else 1)
            wall = max(wall, comm["T"])
            upload_bytes += comm["payload_bytes"]
            if self.mode == "fedsgd":
                loss, g, masks = _client_grad_fn(loss_fn, c.plan)(
                    self.params, batch)
            else:
                loss, g, masks = _client_local_train_fn(
                    loss_fn, c.plan, self.local_steps, self.local_lr)(
                        self.params, batch)
            g, new_ef = _maybe_quantize_upload(
                g, self.upload_quant,
                c.ef_buffer if self.error_feedback else None, self.params)
            if self.error_feedback:
                c.ef_buffer = new_ef
            grads_list.append(g)
            masks_list.append(masks)
            weights.append(c.plan.weight)
            losses.append(loss)
        if grads_list:
            apply = _apply_fns(self.optimizer, self.mode, self.server_lr)
            self.params, self.opt_state = apply(
                hetero_aggregate(grads_list, masks_list, weights),
                self.opt_state, self.params, self.step)
        self.step += 1
        # the round's single device -> host sync
        losses = torch.stack(losses).cpu().tolist() if losses else []
        rec = {"step": self.step,
               "loss": sum(losses) / len(losses) if losses else None,
               "client_losses": losses,
               "n_participants": len(losses),
               "round_wall_time": wall,
               "total_upload_bytes": upload_bytes}
        self.history.append(rec)
        return rec


# ---------------------------------------------------- cohort runtime

def _memo_submodel_spec(cache: dict, ci: int, params: dict,
                        plan: CompressionPlan):
    """Cohort ``ci``'s SubmodelSpec (None for unstructured plans),
    memoized in ``cache``: param shapes are static per server."""
    if not plan.structured:
        return None
    if ci not in cache:
        cache[ci] = submodel_spec(params, plan.width)
    return cache[ci]


def _cohort_ef(server, cohort: Cohort, params: dict) -> dict:
    """A cohort's residuals for its next step: the stacked buffer (zeros
    the first time, and every time when feedback is off), or an empty
    dict without upload quantization. Shared by the sync and async
    cohort runtimes."""
    if server.upload_quant is None:
        return {}
    if cohort.ef_buffer is None or not server.error_feedback:
        return _init_cohort_ef(cohort.size,
                               _local_param_struct(params, cohort.plan))
    return cohort.ef_buffer


def _cohort_upload(server, cohort: Cohort, part: np.ndarray, params: dict):
    """One cohort's participation-masked step against ``params``, shared
    by the sync and async runtimes; keeps the cohort's EF buffer. Returns
    ``(update_sum, masks, loss_sum)``."""
    step = cohort_step_fn(server.model.loss_fn, cohort.plan, server.mode,
                          server.local_steps, server.local_lr,
                          server.upload_quant)
    part_dev = torch.as_tensor(part, dtype=torch.float32).to(server.device)
    g_sum, masks, l_sum, new_ef = step(params, cohort.data, part_dev,
                                       _cohort_ef(server, cohort, params))
    if server.upload_quant is not None and server.error_feedback:
        cohort.ef_buffer = new_ef
    return g_sum, masks, l_sum


@dataclass
class CohortFLServer:
    """Cohort-vectorized federated runtime: a round costs O(#plans) steps
    and one device -> host sync.

    Scenario knobs: ``sample_fraction`` (per-round uniform sampling
    without replacement across the fleet), ``straggler`` (``"wait"``
    blocks on the slowest sampled client; ``"drop"`` discards clients
    whose Eq. (1) time exceeds ``deadline``), and error-feedback
    residuals that survive rounds a client is not sampled.
    """
    model: Any
    optimizer: Any
    cohorts: list[Cohort]
    params: dict
    opt_state: Any = None
    mode: str = "fedsgd"            # fedsgd | fedavg
    local_steps: int = 5
    local_lr: float = 0.1
    server_lr: float = 1.0
    upload_quant: str | None = None
    error_feedback: bool = False
    sample_fraction: float = 1.0
    straggler: str = "wait"         # wait | drop
    deadline: float | None = None
    seed: int = 0
    step: int = 0
    history: list = field(default_factory=list)
    _times_cache: dict = field(default_factory=dict, init=False, repr=False)
    _spec_cache: dict = field(default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(self.params)
        if self.straggler not in ("wait", "drop"):
            raise ValueError(f"straggler must be wait|drop, got {self.straggler!r}")
        if self.straggler == "drop" and self.deadline is None:
            raise ValueError("straggler='drop' requires a deadline (seconds)")

    @classmethod
    def from_clients(cls, clients: list[Client], device,
                     **kw) -> "CohortFLServer":
        return cls(cohorts=build_cohorts(clients, device), **kw)

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    @property
    def n_clients(self) -> int:
        return sum(c.size for c in self.cohorts)

    @property
    def any_structured(self) -> bool:
        return any(c.plan.structured for c in self.cohorts)

    def cohort_spec(self, ci: int):
        """Cohort ``ci``'s SubmodelSpec (None for unstructured plans),
        memoized — param shapes are static per server."""
        return _memo_submodel_spec(self._spec_cache, ci, self.params,
                                   self.cohorts[ci].plan)

    def cohort_times(self, ci: int, n_batch: int) -> dict:
        """Cohort ``ci``'s Eq. (1) table at ``n_batch`` samples, memoized
        (arrays are shared — treat as read-only)."""
        key = (ci, n_batch)
        if key not in self._times_cache:
            cohort = self.cohorts[ci]
            self._times_cache[key] = cohort_round_time(
                self.params, cohort.plan,
                [PROFILES[p] for p in cohort.profile_names], n_batch,
                self.local_steps if self.mode == "fedavg" else 1)
        return self._times_cache[key]

    def _sample_participation(self, rng) -> list[np.ndarray]:
        """Uniform without-replacement sampling of
        ``max(1, round(sample_fraction * n_clients))`` clients across all
        cohorts — the reference's draws, draw for draw."""
        sizes = [c.size for c in self.cohorts]
        if self.sample_fraction >= 1.0:
            return [np.ones(s, bool) for s in sizes]
        n_total = sum(sizes)
        n_sel = max(1, int(round(self.sample_fraction * n_total)))
        flat = np.zeros(n_total, bool)
        flat[rng.choice(n_total, size=n_sel, replace=False)] = True
        out, off = [], 0
        for s in sizes:
            out.append(flat[off:off + s])
            off += s
        return out

    def round(self) -> dict:
        """One federated round over all cohorts. A round in which nobody
        uploads leaves the params untouched and records ``loss=None``."""
        rng = np.random.default_rng([self.seed, self.step])
        sampled = self._sample_participation(rng)
        acc = zeros_like_acc(self.params, dense_den=self.any_structured)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        n_part_total, n_dropped = 0, 0
        wall, upload_bytes = 0.0, 0.0
        apply = _apply_fns(self.optimizer, self.mode, self.server_lr)
        for ci, (cohort, part) in enumerate(zip(self.cohorts, sampled)):
            times = self.cohort_times(ci, cohort.data["x"].shape[1])
            part = part.copy()
            if self.straggler == "drop":
                late = times["T"] > self.deadline
                n_dropped += int(np.sum(part & late))
                part &= ~late
            if part.any():
                wall = max(wall, float(times["T"][part].max()))
            n_p = int(part.sum())
            if n_p == 0:
                continue
            upload_bytes += float(times["payload_bytes"][part].sum())
            n_part_total += n_p
            g_sum, masks, l_sum = _cohort_upload(self, cohort, part,
                                                 self.params)
            acc = scatter_accumulate(acc, g_sum, masks, self.cohort_spec(ci),
                                     cohort.plan.weight, n_p)
            loss_sum = loss_sum + l_sum
        if n_part_total:
            self.params, self.opt_state = apply(
                finalize(acc), self.opt_state, self.params, self.step)
        self.step += 1
        # the round's single device -> host sync
        mean_loss = (float(loss_sum.item()) / n_part_total if n_part_total
                     else None)
        rec = {"step": self.step, "loss": mean_loss,
               "n_participants": n_part_total, "n_dropped": n_dropped,
               "round_wall_time": (self.deadline
                                   if self.straggler == "drop" and n_dropped
                                   else wall),
               "total_upload_bytes": upload_bytes}
        self.history.append(rec)
        return rec


# ------------------------------------------------------ async runtime

def window_groups(slots: list[tuple[int, int]], clients, versions
                  ) -> list[tuple[tuple[int, int], list[int]]]:
    """Re-batch one aggregation window's uploads into (cohort, version)
    groups, sorted by (cohort, version): the apply order the eager server
    and the window engine share. ``slots[c]`` maps scheduler client
    ``c`` to its (cohort index, cohort row); ``clients``/``versions``
    are the window's uploads in arrival order. Each group shares params
    and plan, so it is one cohort step."""
    groups: dict[tuple[int, int], list[int]] = {}
    for c, v in zip(clients, versions):
        ci, row = slots[int(c)]
        groups.setdefault((ci, int(v)), []).append(row)
    return sorted(groups.items())


@dataclass
class AsyncFLServer:
    """Event-driven asynchronous runtime (FedBuff-shaped). A
    :class:`~repro_torch.core.schedule.VirtualClockScheduler` turns each
    client's Eq. (1) round time into upload arrivals; the server
    aggregates once ``buffer_size`` uploads are buffered. Each client
    trains against the global version it last downloaded, so a window
    can mix versions: its uploads are re-batched into (cohort, version)
    groups (:func:`window_groups`), each one cohort step whose
    participation mask selects its clients.

    A group at staleness ``s`` contributes with the discount
    ``(1+s)^-staleness_exp``, computed in float64 on the host and
    rounded to f32, on the numerator only (``staleness_exp=0`` turns it
    off). With ``buffer_size == n_clients`` and no discount every window
    is one synchronous round on the live version: the trajectory is
    ``CohortFLServer``'s sync-wait run.

    The server keeps every global version an in-flight client still
    trains against, refcounted by outstanding dispatches and dropped when
    the last trainer uploads: O(live versions) copies of ``params``.
    """
    model: Any
    optimizer: Any
    cohorts: list[Cohort]
    params: dict
    opt_state: Any = None
    mode: str = "fedsgd"            # fedsgd | fedavg
    local_steps: int = 5
    local_lr: float = 0.1
    server_lr: float = 1.0
    upload_quant: str | None = None
    error_feedback: bool = False
    buffer_size: int = 1            # uploads per aggregation (K of FedBuff)
    staleness_exp: float = 0.5      # a in (1+s)^-a; 0 turns the discount off
    time_jitter: float = 0.0        # lognormal sigma on per-dispatch times
    faults: Any = None
    seed: int = 0
    # global model version (= windows applied)
    version: int = field(default=0, init=False)
    history: list = field(default_factory=list)

    def __post_init__(self):
        if self.faults is not None:
            raise not_ported("a FaultPolicy on the async runtime", "Faults")
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(self.params)
        if self.mode not in ("fedsgd", "fedavg"):
            raise ValueError(f"mode must be fedsgd|fedavg, got {self.mode!r}")
        if self.staleness_exp < 0:
            raise ValueError("staleness_exp must be >= 0")
        self._spec_cache: dict = {}
        # the fleet as scheduler slots: client index -> (cohort, row)
        self._slots: list[tuple[int, int]] = []
        times, payload = [], []
        for ci, cohort in enumerate(self.cohorts):
            t = cohort_round_time(
                self.params, cohort.plan,
                [PROFILES[p] for p in cohort.profile_names],
                cohort.data["x"].shape[1],
                self.local_steps if self.mode == "fedavg" else 1)
            for r in range(cohort.size):
                self._slots.append((ci, r))
                times.append(float(t["T"][r]))
                payload.append(float(t["payload_bytes"][r]))
        self._payload_bytes = payload
        self._sched = VirtualClockScheduler(times, self.buffer_size,
                                            seed=self.seed,
                                            jitter=self.time_jitter)
        # version store, refcounted by outstanding dispatches
        self._versions = {self.version: self.params}
        self._refs = {self.version: len(times)}

    @classmethod
    def from_clients(cls, clients: list[Client], device,
                     **kw) -> "AsyncFLServer":
        return cls(cohorts=build_cohorts(clients, device), **kw)

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    @property
    def n_clients(self) -> int:
        return sum(c.size for c in self.cohorts)

    @property
    def any_structured(self) -> bool:
        return any(c.plan.structured for c in self.cohorts)

    @property
    def n_versions_live(self) -> int:
        return len(self._versions)

    def cohort_spec(self, ci: int):
        return _memo_submodel_spec(self._spec_cache, ci, self.params,
                                   self.cohorts[ci].plan)

    def discount(self, staleness: int) -> float:
        """``(1+s)^-a`` in float64 (rounded to f32 where it is used)."""
        return (1.0 + staleness) ** (-self.staleness_exp)

    def step(self) -> dict:
        """One buffered aggregation window: advance the virtual clock to
        the next ``buffer_size`` arrivals, apply their staleness-
        discounted aggregate, publish the new global version."""
        win = self._sched.next_window()
        groups = window_groups(self._slots, [u.client for u in win.uploads],
                               [u.version for u in win.uploads])
        acc = zeros_like_acc(self.params, dense_den=self.any_structured)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for (ci, v), rows in groups:
            cohort = self.cohorts[ci]
            part = np.zeros(cohort.size, bool)
            part[rows] = True
            g_sum, masks, l_sum = _cohort_upload(self, cohort, part,
                                                 self._versions[v])
            acc = scatter_accumulate(
                acc, g_sum, masks, self.cohort_spec(ci), cohort.plan.weight,
                len(rows), staleness_weight=self.discount(win.version - v))
            loss_sum = loss_sum + l_sum
        apply = _apply_fns(self.optimizer, self.mode, self.server_lr)
        self.params, self.opt_state = apply(finalize(acc), self.opt_state,
                                            self.params, win.version)

        # consumed clients re-download the new global version
        self.version = win.version + 1
        for u in win.uploads:
            self._refs[u.version] -= 1
        self._versions[self.version] = self.params
        self._refs[self.version] = (self._refs.get(self.version, 0)
                                    + len(win.uploads))
        for v in [v for v, c in self._refs.items()
                  if c == 0 and v != self.version]:
            del self._refs[v]
            del self._versions[v]

        stale = win.stalenesses
        # the window's single device -> host sync
        rec = {"step": self.version, "t": win.t,
               "loss": float(loss_sum.item()) / len(win.uploads),
               "n_updates": len(win.uploads),
               "staleness_mean": float(np.mean(stale)),
               "staleness_max": int(max(stale)),
               "n_versions_live": self.n_versions_live,
               "total_upload_bytes": sum(self._payload_bytes[u.client]
                                         for u in win.uploads)}
        self.history.append(rec)
        return rec

    def run(self, n_windows: int) -> dict:
        """Apply ``n_windows`` windows; returns the last record."""
        if n_windows < 1:
            raise ValueError(f"n_windows must be >= 1, got {n_windows}")
        for _ in range(n_windows):
            rec = self.step()
        return rec
