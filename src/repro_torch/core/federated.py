"""The cohort-vectorized federated runtime (paper Fig. 1):

  global model --compress(plan_c)--> local model on device c
  local model  --train on local data--> gradients (or deltas)
  gradients    --upload (optionally quantized, with error feedback)--> server
  server       --hetero-aggregate + optimizer step--> new global model

Clients sharing a ``CompressionPlan`` form a :class:`Cohort`; their data
is stacked on a leading client axis and one step runs per cohort, with
the client axis written out in the tensors (no Python loop over
clients). Two aggregation modes (paper §4.2): fedsgd (one local gradient
per round) and fedavg (``local_steps`` of compressed-space SGD, then the
parameter deltas). Beyond-paper: upload quantization with per-client
error feedback.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.aggregation import (finalize, scatter_accumulate,
                                          zeros_like_acc)
from repro_torch.core.compression import (CompressionPlan, compress_params,
                                          slice_tree, submodel_spec)
from repro_torch.core.compression.quantization import _quant
from repro_torch.core.heterogeneity import PROFILES, cohort_round_time
from repro_torch.data.federated import stack_shards
from repro_torch.numerics import FORMATS


@dataclass
class Client:
    id: int
    plan: CompressionPlan
    data: dict                      # {"x": (n, F), "y": (n,)} host tensors
    profile_name: str = "mid"


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
        plan = self.cohorts[ci].plan
        if not plan.structured:
            return None
        if ci not in self._spec_cache:
            self._spec_cache[ci] = submodel_spec(self.params, plan.width)
        return self._spec_cache[ci]

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

    def ef_for(self, ci: int) -> dict:
        """Cohort ``ci``'s residuals for this round's step: the stacked
        buffer (zeros the first time, and every round when feedback is
        off), or an empty dict without upload quantization."""
        cohort = self.cohorts[ci]
        if self.upload_quant is None:
            return {}
        if cohort.ef_buffer is None or not self.error_feedback:
            return _init_cohort_ef(
                cohort.size, _local_param_struct(self.params, cohort.plan))
        return cohort.ef_buffer

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
            step = cohort_step_fn(self.model.loss_fn, cohort.plan, self.mode,
                                  self.local_steps, self.local_lr,
                                  self.upload_quant)
            part_dev = torch.as_tensor(part, dtype=torch.float32).to(self.device)
            g_sum, masks, l_sum, new_ef = step(self.params, cohort.data,
                                               part_dev, self.ef_for(ci))
            if self.upload_quant is not None and self.error_feedback:
                cohort.ef_buffer = new_ef
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
