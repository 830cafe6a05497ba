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

A hierarchical fleet (``CohortFLServer.topology``, a
:class:`~repro_torch.core.topology.FleetTopology`) arranges each cohort
as an ``(E, cap, ...)`` edge grid: :func:`edge_step_fn` computes every
edge gateway's partial aggregate and the hub chains the partials in
fixed edge order (:func:`_hub_combine`).

A :class:`~repro_torch.core.faults.FaultPolicy` (``faults=``) layers
availability traces, mid-round dropouts, corrupted uploads and the
server's defences over any of the three (the reference's semantics,
mask for mask); ``faults=None`` leaves every runtime on its clean path.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.aggregation import (finalize, hetero_aggregate,
                                          scatter_accumulate, zeros_like_acc)
from repro_torch.core.compression import (CompressionPlan, compress_params,
                                          expand_update, slice_tree,
                                          submodel_spec)
from repro_torch.core.compression.quantization import _quant
from repro_torch.core.faults import (FaultPolicy, availability_mask,
                                     clip_updates, corrupt_mask,
                                     corrupt_seq_mask, dropout_mask,
                                     finite_guard, inject_corruption)
from repro_torch.core.heterogeneity import (PROFILES, cohort_round_time,
                                            round_time)
from repro_torch.core.schedule import RetrySpec, VirtualClockScheduler
from repro_torch.core.topology import (EdgeBlocks, EdgeCohort,
                                       build_edge_cohorts, edge_blocks,
                                       edge_sharding, scatter_part)
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


def build_cohorts(clients: list[Client], device, topology=None) -> list:
    """Group clients by plan (first-appearance order; client order kept
    within a cohort) and stack their shards onto ``device``. With a
    :class:`~repro_torch.core.topology.FleetTopology` the same groups are
    arranged as edge grids instead (:func:`build_edge_cohorts`)."""
    if topology is not None:
        return build_edge_cohorts(clients, topology, device)
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


def _init_edge_ef(n_edges: int, cap: int, params: dict) -> dict:
    """The edge grid's residuals: one zero row per ``(edge, grid row)``
    cell; padding cells keep zeros (their participation never flips)."""
    return {k: torch.zeros((n_edges, cap) + tuple(p.shape), dtype=p.dtype,
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


def _base_fn(plan: CompressionPlan) -> Callable:
    """``params -> the model the plan trains``: the width slice for
    structured plans, ``params`` itself otherwise."""
    if not plan.structured:
        return lambda params: params
    return lambda params: slice_tree(params, submodel_spec(params,
                                                           plan.width))


def _client_updates_fn(loss_fn: Callable, plan: CompressionPlan, mode: str,
                       local_steps: int, local_lr: float) -> Callable:
    """Every client's own update at once, ``(params, batches) ->
    (losses, updates, masks)`` with a leading client axis on the first
    two: fedsgd differentiates per-client copies of the weights, fedavg
    runs :func:`_local_sgd` and returns deltas."""
    inner = plan.inner()
    base = _base_fn(plan)
    if mode == "fedsgd":
        def f(params, batches):
            p0 = base(params)
            n = next(iter(batches.values())).shape[0]
            with torch.enable_grad():
                pc = _leaf_copies(p0, n)
                cp, _ = compress_params(pc, inner, batch=1)
                losses = loss_fn(cp, batches)
                grads = _grads(losses.sum(), pc)
            with torch.no_grad():
                _, masks = compress_params(p0, inner)
            return losses.detach(), grads, masks
        return f

    local = _local_sgd(loss_fn, plan, local_steps, local_lr)

    def f(params, batches):
        with torch.no_grad():
            cp0, masks = compress_params(base(params), inner)
        losses, deltas = local(cp0, batches)
        return losses, deltas, masks
    return f


def cohort_step_fn(loss_fn: Callable, plan: CompressionPlan, mode: str,
                   local_steps: int, local_lr: float,
                   upload_fmt: str | None) -> Callable:
    """The one-cohort round step,
    ``(params, batches, part, ef) -> (update_sum, masks, loss_sum, ef)``.

    fedsgd without upload quantization differentiates the participation-
    weighted loss SUM once (its gradient is the sum of the per-client
    gradients); everything else needs each client's update
    (:func:`_client_updates_fn`; the EF residuals are per client) and
    sums them after the upload. Structured plans slice the global params
    first and return SUB-shaped updates and masks.
    """
    if mode == "fedsgd" and upload_fmt is None:
        inner = plan.inner()
        base = _base_fn(plan)

        def f(params, batches, part, ef):
            with torch.enable_grad():
                p = _leaf_copies(base(params))
                cp, masks = compress_params(p, inner)
                l_sum = torch.sum(part * loss_fn(cp, batches))
                g_sum = _grads(l_sum, p)
            return g_sum, masks, l_sum.detach(), ef
        return f

    updates_of = _client_updates_fn(loss_fn, plan, mode, local_steps,
                                    local_lr)

    def f(params, batches, part, ef):
        losses, ups, masks = updates_of(params, batches)
        u_sum, ef = _upload_and_sum(ups, part, ef, upload_fmt)
        return u_sum, masks, torch.sum(part * losses), ef
    return f


def fault_cohort_step_fn(loss_fn: Callable, plan: CompressionPlan, mode: str,
                         local_steps: int, local_lr: float,
                         upload_fmt: str | None,
                         faults: FaultPolicy) -> Callable:
    """The fault twin of :func:`cohort_step_fn`, ``(params, batches,
    part, ef, corrupt, uid) -> (update_sum, masks, cov, loss_sum, ef)``,
    for policies that touch uploads. It always takes the per-client
    branches (corruption and the defences act on single uploads), in
    transit order:

      local step -> quantize and bank the EF residual (on the client,
      from the true update) -> poison the rows ``corrupt`` flags
      (element subset keyed by ``uid``) -> finite guard (zero non-finite
      elements, collect 0/1 coverage) -> per-client norm clip ->
      participation-weighted sum.

    ``cov`` is the participation-weighted coverage sum, the
    per-coordinate denominator of ``scatter_accumulate(cov=...)``, or
    ``None`` with the guard off (NaN then reaches the params).
    """
    updates_of = _client_updates_fn(loss_fn, plan, mode, local_steps,
                                    local_lr)

    def f(params, batches, part, ef, corrupt, uid):
        losses, ups, masks = updates_of(params, batches)
        ups, ef = _quantize_clients(ups, part, ef, upload_fmt)
        if faults.corrupt_rate > 0.0:
            ups = inject_corruption(ups, corrupt, uid, faults)
        cov = None
        if faults.finite_guard:
            ups, fin = finite_guard(ups)
            cov = {k: torch.tensordot(part, m, dims=1)
                   for k, m in fin.items()}
        if faults.clip_norm is not None:
            ups = clip_updates(ups, faults.clip_norm)
        u_sum = {k: torch.tensordot(part, u, dims=1) for k, u in ups.items()}
        return u_sum, masks, cov, torch.sum(part * losses), ef
    return f


# ------------------------------------------------------------ edge step

def _block_compress(p: dict, plan: CompressionPlan, n_edges: int):
    """``compress_params(p, plan, batch=1)`` over a block's leading copies,
    ``n_edges`` equal groups of them. Pruning, fake-quant and their
    straight-through backward are elementwise or exact (a max, integer
    counts), so a copy's bits do not depend on how many share the call;
    k-means clustering sums through batched products, so a plan with a
    codebook compresses one edge's group at a time."""
    if not plan.cluster_k:
        return compress_params(p, plan, batch=1)
    n = next(iter(p.values())).shape[0] // n_edges
    parts = [compress_params({k: v[j * n:(j + 1) * n] for k, v in p.items()},
                             plan, batch=1) for j in range(n_edges)]
    cp = {k: torch.cat([c[k] for c, _ in parts]) for k in p}
    masks = {k: m if m.dim() == 0 else torch.cat([ms[k] for _, ms in parts])
             for k, m in parts[0][1].items()}
    return cp, masks


def _edge_leaves(cp: dict, rows: slice | int) -> dict:
    """Fresh autograd leaves holding ``cp``'s rows for one edge."""
    return {k: v[rows].detach().requires_grad_(True) for k, v in cp.items()}


def _through_compression(cp: dict, p: dict, d_cp: dict) -> dict:
    """The gradient w.r.t. ``p`` of ``d_cp``, a gradient w.r.t. the
    compressed ``cp``: the compression's straight-through backward."""
    keys = list(p)
    return dict(zip(keys, torch.autograd.grad(
        [cp[k] for k in keys], [p[k] for k in keys],
        grad_outputs=[d_cp[k] for k in keys])))


def _edge_client_updates_fn(loss_fn: Callable, plan: CompressionPlan,
                            mode: str, local_steps: int,
                            local_lr: float) -> Callable:
    """:func:`_client_updates_fn` over a block of ``nb`` edges of ``cap``
    clients, ``(params, batches, nb, cap) -> (losses, updates, masks)``
    with ``nb * cap`` client rows: the compressions batched over the
    block, each edge's forward and backward on its own ``cap`` rows."""
    inner = plan.inner()
    base = _base_fn(plan)

    def edge_grads(w: dict, batches: dict, nb: int, cap: int):
        losses, grads = [], []
        for j in range(nb):
            rows = slice(j * cap, (j + 1) * cap)
            wj = _edge_leaves(w, rows)
            with torch.enable_grad():
                lj = loss_fn(wj, {k: v[j] for k, v in batches.items()})
                grads.append(_grads(lj.sum(), wj))
            losses.append(lj.detach())
        return (torch.cat(losses),
                {k: torch.cat([g[k] for g in grads]) for k in w})

    if mode == "fedsgd":
        def f(params, batches, nb, cap):
            p0 = base(params)
            with torch.enable_grad():
                pc = _leaf_copies(p0, nb * cap)
                cp, _ = _block_compress(pc, inner, nb)
            losses, d_cp = edge_grads(cp, batches, nb, cap)
            grads = _through_compression(cp, pc, d_cp)
            with torch.no_grad():
                _, masks = compress_params(p0, inner)
            return losses, grads, masks
        return f

    def f(params, batches, nb, cap):
        with torch.no_grad():
            cp0, masks = compress_params(base(params), inner)
        w = {k: v.detach() for k, v in _leaf_copies(cp0, nb * cap).items()}
        for _ in range(local_steps):
            losses, g = edge_grads(w, batches, nb, cap)
            with torch.no_grad():
                w = {k: v - local_lr * g[k] for k, v in w.items()}
                w = _block_compress(w, inner, nb)[0]
        return losses, {k: v - cp0[k] for k, v in w.items()}, masks
    return f


def edge_step_fn(loss_fn: Callable, plan: CompressionPlan, mode: str,
                 local_steps: int, local_lr: float,
                 upload_fmt: str | None) -> Callable:
    """The EDGE step: :func:`cohort_step_fn` with a leading edge axis,
    ``(params, (nb,cap,n,...) batches, (nb,cap) part, (nb,cap,...) ef) ->
    ((nb,...) update sums, (nb,...) masks, (nb,) loss sums, ef)`` for a
    block of ``nb`` edges: every edge gateway's partial aggregate.

    Each edge's bits must not depend on how many edges share the block (a
    sharded run is bitwise the unsharded one), and a batched product or
    reduction may round differently at another batch count. So the model
    compressions run once over the block (elementwise ops and exact
    reductions: :func:`_block_compress`), and every product and inexact
    reduction runs per edge in the edge's own shapes: its forward and
    backward, its participation-weighted sums. fedsgd without upload
    quantization differentiates each edge's weighted loss sum against
    the edge's copy of the (sliced) params; the other branches take the
    block's ``nb * cap`` client rows and sum each edge's with its part
    row after the upload (quantization and EF are elementwise)."""
    if mode == "fedsgd" and upload_fmt is None:
        inner = plan.inner()
        base = _base_fn(plan)

        def f(params, batches, part, ef):
            nb = part.shape[0]
            with torch.enable_grad():
                p = _leaf_copies(base(params), nb)
                cp, masks = _block_compress(p, inner, nb)
            d_cp, l_sums = [], []
            for j in range(nb):
                wj = _edge_leaves(cp, j)
                with torch.enable_grad():
                    lj = torch.sum(part[j] * loss_fn(
                        wj, {k: v[j] for k, v in batches.items()}))
                    d_cp.append(_grads(lj, wj))
                l_sums.append(lj.detach())
            g = _through_compression(
                cp, p, {k: torch.stack([d[k] for d in d_cp]) for k in p})
            masks = {k: m.expand(nb) if m.dim() == 0 else m
                     for k, m in masks.items()}
            return g, masks, torch.stack(l_sums), ef
        return f

    updates_of = _edge_client_updates_fn(loss_fn, plan, mode, local_steps,
                                         local_lr)

    def f(params, batches, part, ef):
        nb, cap = part.shape
        losses, ups, masks = updates_of(params, batches, nb, cap)
        flat = {k: v.reshape((nb * cap,) + tuple(v.shape[2:]))
                for k, v in ef.items()}
        ups, flat = _quantize_clients(ups, part.reshape(-1), flat, upload_fmt)
        u_sums = {k: torch.stack([torch.tensordot(
            part[j], u[j * cap:(j + 1) * cap], dims=1) for j in range(nb)])
            for k, u in ups.items()}
        l_sums = torch.stack([torch.sum(part[j] * losses[j * cap:(j + 1) * cap])
                              for j in range(nb)])
        masks = {k: m.expand((nb,) + tuple(m.shape)) for k, m in masks.items()}
        return u_sums, masks, l_sums, {
            k: v.reshape((nb, cap) + tuple(v.shape[1:]))
            for k, v in flat.items()}
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
    steps per round and one device -> host sync.

    Under a :class:`FaultPolicy` an unavailable client never starts, a
    mid-round dropout burns its Eq. (1) time but uploads nothing, and an
    upload that touches the fault path goes through the cohort fault
    step's inject -> guard -> clip order as a one-row stack, its finite
    mask folded into its aggregation mask."""
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
    faults: FaultPolicy | None = None
    step: int = 0
    history: list = field(default_factory=list)

    def __post_init__(self):
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
        flt = self.faults
        n = len(self.clients)
        if flt is not None:
            avail = availability_mask(flt, n, self.step)
            drops = dropout_mask(flt, n, self.step)
            corr = corrupt_mask(flt, n, self.step)
        grads_list, masks_list, weights, losses = [], [], [], []
        n_dropouts = n_corrupt = 0
        wall, upload_bytes = 0.0, 0.0
        for i, (c, batch) in enumerate(zip(self.clients, batches)):
            if flt is not None and not avail[i]:
                continue                    # down: never dispatched
            n_batch = next(iter(batch.values())).shape[0]
            comm = round_time(self.params, c.plan, PROFILES[c.profile_name],
                              n_batch,
                              self.local_steps if self.mode == "fedavg" else 1)
            wall = max(wall, comm["T"])
            if flt is not None and drops[i]:
                n_dropouts += 1             # crashed before upload
                continue
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
            if flt is not None and flt.touches_uploads:
                g1 = {k: x.unsqueeze(0) for k, x in g.items()}
                if flt.corrupt_rate > 0.0:
                    hit = bool(corr[i])
                    n_corrupt += int(hit)
                    g1 = inject_corruption(
                        g1, torch.tensor([float(hit)], device=self.device),
                        torch.tensor([self.step * n + i], dtype=torch.int64,
                                     device=self.device), flt)
                if flt.finite_guard:
                    g1, fin1 = finite_guard(g1)
                    masks = {k: m * fin1[k][0] for k, m in masks.items()}
                if flt.clip_norm is not None:
                    g1 = clip_updates(g1, flt.clip_norm)
                g = {k: x[0] for k, x in g1.items()}
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
        if flt is not None:
            rec["n_dropouts"] = n_dropouts
            rec["n_corrupt"] = n_corrupt
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


def _on_device(x, dtype, device) -> torch.Tensor:
    """A host array (or a tensor already there) as ``dtype`` on ``device``."""
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def _cohort_upload(server, cohort: Cohort, part, params: dict,
                   batches: dict | None = None):
    """One cohort's participation-masked step against ``params`` on
    ``batches`` (default: the cohort's data), shared by the sync and
    async runtimes; keeps the cohort's EF buffer. Returns
    ``(update_sum, masks, loss_sum)``."""
    step = cohort_step_fn(server.model.loss_fn, cohort.plan, server.mode,
                          server.local_steps, server.local_lr,
                          server.upload_quant)
    g_sum, masks, l_sum, new_ef = step(
        params, cohort.data if batches is None else batches,
        _on_device(part, torch.float32, server.device),
        _cohort_ef(server, cohort, params))
    if server.upload_quant is not None and server.error_feedback:
        cohort.ef_buffer = new_ef
    return g_sum, masks, l_sum


def _fault_cohort_upload(server, cohort: Cohort, part, params: dict,
                         corrupt, uid, batches: dict | None = None):
    """:func:`_cohort_upload`'s fault twin: the cohort's
    :func:`fault_cohort_step_fn` with the round's per-row corruption
    flags and per-upload uids. Returns ``(update_sum, masks, cov,
    loss_sum)``; ``cov`` is None with the finite guard off."""
    step = fault_cohort_step_fn(server.model.loss_fn, cohort.plan,
                                server.mode, server.local_steps,
                                server.local_lr, server.upload_quant,
                                server.faults)
    dev = server.device
    g_sum, masks, cov, l_sum, new_ef = step(
        params, cohort.data if batches is None else batches,
        _on_device(part, torch.float32, dev),
        _cohort_ef(server, cohort, params),
        _on_device(corrupt, torch.float32, dev),
        _on_device(uid, torch.int64, dev))
    if server.upload_quant is not None and server.error_feedback:
        cohort.ef_buffer = new_ef
    return g_sum, masks, cov, l_sum


def _guard_cov_active(faults: FaultPolicy | None) -> bool:
    """True when the fault path emits per-coordinate coverage: the
    accumulators then need dense denominators, in the eager rounds and
    the engines alike."""
    return (faults is not None and faults.touches_uploads
            and faults.finite_guard)


def _n_batch(cohort, batches: dict | None = None) -> int:
    """Samples per client of ``batches`` (default: the cohort's data):
    axis 2 of an edge grid, axis 1 of a cohort."""
    data = cohort.data if batches is None else batches
    return next(iter(data.values())).shape[
        2 if isinstance(cohort, EdgeCohort) else 1]


def _place_edges(server, t: torch.Tensor) -> tuple:
    """``t``'s leading edge axis in the server's blocks: one block on the
    server's device, or the mesh's blocks (one copy each)."""
    if server.mesh is None:
        return (t.to(server.device),)
    return edge_sharding(server.mesh).put(t).blocks


def _edge_ef(server, cohort: EdgeCohort, params: dict) -> dict:
    """An edge cohort's residuals for its next step: its grid buffer
    (zeros the first time, and every time when feedback is off; in the
    mesh's blocks under a mesh), or an empty dict without upload
    quantization."""
    if server.upload_quant is None:
        return {}
    if cohort.ef_buffer is not None and server.error_feedback:
        return cohort.ef_buffer
    ef = _init_edge_ef(cohort.n_edges, cohort.cap,
                       _local_param_struct(params, cohort.plan))
    if server.mesh is not None:
        ef = {k: edge_sharding(server.mesh).put(v) for k, v in ef.items()}
    return ef


def _edge_upload(server, cohort: EdgeCohort, step: Callable, params: dict,
                 part_blocks, ef: dict, batches: dict | None = None):
    """``step`` (an :func:`edge_step_fn`) on each block of the cohort's
    grid, on the block's device against its own copy of ``params``.
    Returns the per-edge ``(update_sums, masks, loss_sums)`` stacked on
    the hub (the server's device) and the new EF grid, in blocks as the
    data is."""
    hub = server.device
    data = cohort.data if batches is None else batches
    outs = []
    for b, part in enumerate(part_blocks):
        dev = part.device
        outs.append(step({k: v.to(dev) for k, v in params.items()},
                         {k: edge_blocks(v)[b] for k, v in data.items()},
                         part, {k: edge_blocks(v)[b] for k, v in ef.items()}))
    if len(outs) == 1 and server.mesh is None:
        return outs[0]

    def hub_cat(i):
        return {k: torch.cat([o[i][k].to(hub) for o in outs])
                for k in outs[0][i]}
    return (hub_cat(0), hub_cat(1),
            torch.cat([o[2].to(hub) for o in outs]),
            {k: EdgeBlocks([o[3][k] for o in outs]) for k in outs[0][3]})


def _hub_combine(acc, loss_sum: torch.Tensor, g_sums: dict, masks: dict,
                 l_sums: torch.Tensor, spec, weight: float, counts):
    """The hub's fixed-order combine of one plan's edge partials: edges in
    index order through ``scatter_accumulate``, then the loss partial of
    each. The only arithmetic across edges; an empty edge adds exact
    zeros. Shared by the eager round and the engine."""
    for e in range(len(counts)):
        acc = scatter_accumulate(acc, {k: v[e] for k, v in g_sums.items()},
                                 {k: v[e] for k, v in masks.items()}, spec,
                                 weight, float(counts[e]))
        loss_sum = loss_sum + l_sums[e]
    return acc, loss_sum


def _edge_cohort_upload(server, cohort: EdgeCohort, part_flat, params: dict,
                        batches: dict | None = None):
    """One edge cohort's participation-masked upload: the flat sampled
    mask scattered into the ``(E, cap)`` grid, the edge step per block,
    the grid EF buffer kept. Returns the per-edge ``(update_sums, masks,
    loss_sums)`` for the hub's combine."""
    step = edge_step_fn(server.model.loss_fn, cohort.plan, server.mode,
                        server.local_steps, server.local_lr,
                        server.upload_quant)
    part = _place_edges(server, torch.from_numpy(scatter_part(cohort,
                                                              part_flat)))
    g_sums, masks, l_sums, new_ef = _edge_upload(
        server, cohort, step, params, part, _edge_ef(server, cohort, params),
        batches)
    if server.upload_quant is not None and server.error_feedback:
        cohort.ef_buffer = new_ef
    return g_sums, masks, l_sums


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
    faults: FaultPolicy | None = None
    seed: int = 0
    step: int = 0
    # hierarchical fleets: the FleetTopology the cohorts were gridded
    # against (None: a flat fleet), and the EdgeMesh shard_fleet placed
    # the grids on (None: unsharded)
    topology: Any = None
    mesh: Any = field(default=None, init=False, repr=False)
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
        if (self.faults is not None and self.faults.touches_uploads
                and self.topology is not None):
            raise ValueError(
                "upload corruption/defenses are not modeled for hierarchical "
                "fleets (quarantine would happen at the edge gateways); "
                "availability/churn/dropout faults are fine")

    @classmethod
    def from_clients(cls, clients: list[Client], device, topology=None,
                     **kw) -> "CohortFLServer":
        return cls(cohorts=build_cohorts(clients, device, topology),
                   topology=topology, **kw)

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

    def _place_batches(self, cohort, batches: dict) -> dict:
        """A caller's batches where the cohort's data lives: an edge grid
        in the mesh's blocks (or on the server's device), a cohort's
        stack on the server's device."""
        if isinstance(cohort, EdgeCohort) and self.mesh is not None:
            return {k: edge_sharding(self.mesh).put(torch.as_tensor(v))
                    for k, v in batches.items()}
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batches.items()}

    def round(self, cohort_batches: list[dict] | None = None,
              participation: list | None = None) -> dict:
        """One federated round over all cohorts, in the reference's
        argument order. ``cohort_batches`` (one dict per cohort, laid out
        as the cohort's data) overrides each cohort's stacked local data;
        ``participation`` (one bool array per cohort) overrides the
        sampled participation. Deadline drops and faults apply on top of
        either.

        Under a :class:`FaultPolicy`, per cohort in flat client order:
        availability zeros sampled rows first (a down client burns no
        time), the deadline drops among the available, then mid-round
        dropouts crash clients that ran: their Eq. (1) time burns the
        wall-clock, nothing of them is uploaded, counted or billed.
        Uploads under a policy that touches them go through
        :func:`fault_cohort_step_fn` with uid ``step * n_clients +
        flat index``, corruption flagged on active rows only, and
        aggregate with per-coordinate coverage. A round in which nobody
        uploads leaves the params untouched and records ``loss=None``.
        """
        rng = np.random.default_rng([self.seed, self.step])
        sampled = (self._sample_participation(rng) if participation is None
                   else [np.asarray(p, bool) for p in participation])
        flt = self.faults
        n_total = self.n_clients
        if flt is not None:
            avail = availability_mask(flt, n_total, self.step)
            drops = dropout_mask(flt, n_total, self.step)
            corr = corrupt_mask(flt, n_total, self.step)
        acc = zeros_like_acc(self.params, dense_den=(
            self.any_structured or _guard_cov_active(flt)))
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        n_part_total, n_dropped = 0, 0
        n_dropouts, n_corrupt = 0, 0
        wall, upload_bytes = 0.0, 0.0
        apply = _apply_fns(self.optimizer, self.mode, self.server_lr)
        off = 0
        for ci, (cohort, part) in enumerate(zip(self.cohorts, sampled)):
            off0, off = off, off + cohort.size
            batches = (None if cohort_batches is None
                       else self._place_batches(cohort, cohort_batches[ci]))
            times = self.cohort_times(ci, _n_batch(cohort, batches))
            part = part.copy()
            if flt is not None:
                part &= avail[off0:off]
            if self.straggler == "drop":
                late = times["T"] > self.deadline
                n_dropped += int(np.sum(part & late))
                part &= ~late
            active = part
            if flt is not None and flt.dropout_rate > 0.0:
                crashed = part & drops[off0:off]
                n_dropouts += int(crashed.sum())
                active = part & ~crashed
            if part.any():
                # ran clients burn wall-clock whether or not they crashed
                wall = max(wall, float(times["T"][part].max()))
            n_p = int(active.sum())
            if n_p == 0:
                continue
            upload_bytes += float(times["payload_bytes"][active].sum())
            n_part_total += n_p
            if isinstance(cohort, EdgeCohort):
                # each edge forwards its partial (update sum, masks, loss)
                # and the hub chains them in edge order
                g_sums, masks, l_sums = _edge_cohort_upload(
                    self, cohort, active, self.params, batches)
                acc, loss_sum = _hub_combine(
                    acc, loss_sum, g_sums, masks, l_sums, self.cohort_spec(ci),
                    cohort.plan.weight,
                    np.bincount(cohort.edge_index[active],
                                minlength=cohort.n_edges))
                continue
            cov = None
            if flt is not None and flt.touches_uploads:
                c_row = corr[off0:off] & active
                n_corrupt += int(c_row.sum())
                g_sum, masks, cov, l_sum = _fault_cohort_upload(
                    self, cohort, active, self.params, c_row,
                    self.step * n_total + np.arange(off0, off), batches)
            else:
                g_sum, masks, l_sum = _cohort_upload(self, cohort, active,
                                                     self.params, batches)
            acc = scatter_accumulate(acc, g_sum, masks, self.cohort_spec(ci),
                                     cohort.plan.weight, n_p, cov=cov)
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
        if flt is not None:
            rec["n_dropouts"] = n_dropouts
            rec["n_corrupt"] = n_corrupt
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

    Under a :class:`FaultPolicy` the dropout rate turns lost uploads into
    retransmission delays on the virtual clock (``RetrySpec``), and
    corruption is keyed by each upload's dispatch sequence number
    (:func:`corrupt_seq_mask`), so the window engine poisons the same
    uploads. Availability traces are round-indexed and refused.
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
    faults: FaultPolicy | None = None
    seed: int = 0
    # global model version (= windows applied)
    version: int = field(default=0, init=False)
    history: list = field(default_factory=list)

    def __post_init__(self):
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(self.params)
        if self.mode not in ("fedsgd", "fedavg"):
            raise ValueError(f"mode must be fedsgd|fedavg, got {self.mode!r}")
        if self.staleness_exp < 0:
            raise ValueError("staleness_exp must be >= 0")
        if self.faults is not None and self.faults.traces_availability:
            raise ValueError(
                "availability traces (period/churn) are round-indexed — "
                "the async virtual clock has no round index; model async "
                "flakiness as dropout_rate + retry_backoff instead")
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
        retry = None
        if self.faults is not None and self.faults.dropout_rate > 0.0:
            # lost uploads become deterministic retransmission delays
            retry = RetrySpec(drop_rate=self.faults.dropout_rate,
                              backoff=self.faults.retry_backoff,
                              max_retries=self.faults.max_retries,
                              seed=self.faults.seed)
        self._sched = VirtualClockScheduler(times, self.buffer_size,
                                            seed=self.seed,
                                            jitter=self.time_jitter,
                                            retry=retry)
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

    def fault_rows(self, clients, seqs) -> list[tuple[np.ndarray, np.ndarray]]:
        """Per cohort, the (corruption flags, uids) rows of a window's
        uploads: each upload's flag and uid come from its dispatch
        sequence number; rows without an upload stay (False, 0). Shared
        by :meth:`step` and the window engine."""
        flags = corrupt_seq_mask(self.faults, seqs)
        out = [(np.zeros(c.size, bool), np.zeros(c.size, np.int64))
               for c in self.cohorts]
        for c, s, hit in zip(clients, seqs, flags):
            ci, row = self._slots[int(c)]
            out[ci][0][row] = hit
            out[ci][1][row] = int(s)
        return out

    def step(self) -> dict:
        """One buffered aggregation window: advance the virtual clock to
        the next ``buffer_size`` arrivals, apply their staleness-
        discounted aggregate, publish the new global version."""
        win = self._sched.next_window()
        groups = window_groups(self._slots, [u.client for u in win.uploads],
                               [u.version for u in win.uploads])
        flt = self.faults
        fault_rows = (self.fault_rows([u.client for u in win.uploads],
                                      [u.seq for u in win.uploads])
                      if flt is not None and flt.touches_uploads else None)
        acc = zeros_like_acc(self.params, dense_den=(
            self.any_structured or _guard_cov_active(flt)))
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        n_corrupt = 0
        for (ci, v), rows in groups:
            cohort = self.cohorts[ci]
            part = np.zeros(cohort.size, bool)
            part[rows] = True
            cov = None
            if fault_rows is not None:
                c_row, uid = fault_rows[ci]
                c_row = c_row & part
                n_corrupt += int(c_row.sum())
                g_sum, masks, cov, l_sum = _fault_cohort_upload(
                    self, cohort, part, self._versions[v], c_row, uid)
            else:
                g_sum, masks, l_sum = _cohort_upload(self, cohort, part,
                                                     self._versions[v])
            acc = scatter_accumulate(
                acc, g_sum, masks, self.cohort_spec(ci), cohort.plan.weight,
                len(rows), staleness_weight=self.discount(win.version - v),
                cov=cov)
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
        if flt is not None:
            rec["n_corrupt"] = n_corrupt
        self.history.append(rec)
        return rec

    def run(self, n_windows: int) -> dict:
        """Apply ``n_windows`` windows; returns the last record."""
        if n_windows < 1:
            raise ValueError(f"n_windows must be >= 1, got {n_windows}")
        for _ in range(n_windows):
            rec = self.step()
        return rec
