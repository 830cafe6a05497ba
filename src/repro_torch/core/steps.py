"""The LM steps of the heterogeneous federated round at datacenter
scale, as the reference's ``core/steps.py``.

``make_hetero_train_step`` runs one federated round of the tier plans in
plan order (the reference's ``lax.scan`` over tiers is a Python loop;
one gradient and two accumulators are live at a time):

    for each tier t:
        1. compress the global params with tier t's plan (prune -> fake
           quant, straight-through), cast to the compute dtype;
        2. the gradient of the COMPRESSED model's loss on tier t's
           sub-batch with respect to the f32 global params;
        3. accumulate the mask-aware numerator and denominator
           (``accumulate_cohort`` with count 1: with 0/1 masks its
           ``m * (w * g)`` has the bits of the reference's ``w * m * g``);
    then aggregate (``finalize``) and apply the optimizer to the global
    params. The metrics are the weighted mean loss over the tiers
    (``loss``, as the reference reports it) and each tier's own loss
    (``tier_loss``, in plan order).

Batches arrive shaped (n_tiers, per_tier_batch, ...): every key of the
batch (``tokens``, and ``patches`` for VLM) has the tier axis first.
``num_groups`` is passed to the model's loss, prefill and decode, as in
the reference (the data shards a MoE layer groups its tokens by; 1 on
one card). The plans are
static, so a hub tier (no pruning, no quantization) launches no
fake_quant kernel, and int-k stays plain.

On a mesh of several ranks (the step run inside ``models.parallel.using
(mesh)``, the state placed by ``models.sharding.place``) each rank's
params are its blocks of the leaves: the model's own collectives run the
tensor parallel layers over "model", and each rank of "data" takes its
rows of each tier's batch; see :func:`make_hetero_train_step`.

``make_serve_step`` / ``make_prefill_step`` run the model AS DEPLOYED on
a device tier, with params compressed once by ``compress_for_serving``;
on a mesh of several ranks on each rank's blocks of the params and of
the cache, each data rank its rows of the batch.
"""
from __future__ import annotations

import torch

from repro_torch.core.aggregation import (accumulate_cohort, f32, finalize,
                                          zeros_like_acc)
from repro_torch.core.compression import (CompressionPlan, compress_params,
                                          compress_with_masks, plan_arrays)
from repro_torch.models import parallel
from repro_torch.models.layers import Blocks
from repro_torch.models.sharding import data_splits, place


class TrainState:
    """Train state is a plain dict {"params", "opt", "step"}; this
    namespace only provides the constructor."""

    @staticmethod
    def create(model, optimizer, key, device=None) -> dict:
        """Params from ``model.init(key, device=...)`` (an int seed or a
        ``torch.Generator``), on ``cuda`` unless told otherwise."""
        params = model.init(key, device=device)
        dev = next(iter(params.values())).device
        return dict(params=params, opt=optimizer.init(params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def _grads(loss: torch.Tensor, leaves: dict) -> dict:
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _data_rows(batch: dict) -> dict:
    """This data rank's rows of each tier's batch (the tier axis first,
    the rows second): its slot over the data axes (``parallel.DATA``),
    row-major."""
    n, d = parallel.size(parallel.DATA), parallel.rank(parallel.DATA)
    out = {}
    for k, v in batch.items():
        rows = v.shape[1]
        if rows % n:
            raise ValueError(f"{k}: {rows} rows a tier do not split over "
                             f"{n} data ranks")
        out[k] = v[:, d * rows // n:(d + 1) * rows // n]
    return out


def make_hetero_train_step(model, optimizer, plans: list[CompressionPlan],
                           *, num_groups: int = 1, acc_shardings=None,
                           shardings=None):
    """acc_shardings: optional NamedSharding dict (params-shaped). The
    gradients and the mask-aware accumulators are placed by it, as the
    reference constrains them (``models.sharding.place``: on a mesh of one
    device, the same tensors; on a mesh of several ranks they are already
    each rank's blocks, and stay so).

    shardings: the params' NamedSharding dict (the launcher's
    ``named(mesh, param_spec_tree(state, ...))["params"]``), needed when
    the step runs inside ``parallel.using`` a mesh whose "model" axis
    splits leaves: the pruning of a split leaf searches its threshold
    over the whole leaf. On a mesh of several ranks each "data" rank
    takes its rows of each tier's batch (``B / n_tiers`` must divide over
    "data"); its mask-aware numerator, linear in the gradients and with
    the same masks on every replica, is averaged over "data" once a step,
    and so are the loss and the tier losses. The reference replicates
    the batch over "data" and lets GSPMD split the work: the same
    arithmetic in another order (each rank's mean over its rows, then
    the mean over the ranks).

    A leaf that ``shardings`` split over the data axes too (the FSDP train
    state, ``param_spec_tree(state, M, fsdp=...)``) is this rank's block
    of it: it is pruned and quantized as the whole leaf
    (``compress_with_masks``), cast to the compute dtype, and the model
    reads it through ``layers.Blocks``, which gathers it whole where a
    layer uses it; the backward gathers a layer's leaves again where it
    needs them (``parallel.regathering``; the leaves outside the layer
    stacks stay whole) and reduce-scatters each gradient, already summed
    over "data". Its numerator is then divided by the data ranks
    alone; the leaves with no data entry (the norms) are all-reduced
    over "data" as above. No gradient is summed twice."""
    arrs = plan_arrays(plans)
    wsum = float(sum(p.weight for p in plans))
    # compressed weights live in the model's compute dtype
    cdt = getattr(torch, model.cfg.dtype)

    def constrain(tree: dict) -> dict:
        if acc_shardings is None or parallel.multi_rank():
            return tree
        # rank-mismatched leaves (the scalar denominators of 1-D leaves)
        # stay as they are
        return place(tree, {k: acc_shardings[k]
                            if x.dim() == len(acc_shardings[k].spec) else None
                            for k, x in tree.items()})

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        split = {}
        if parallel.multi_rank():
            if shardings is None and parallel.size("model") > 1:
                raise ValueError("a step on a mesh that splits leaves over "
                                 "\"model\" needs the params' shardings=")
            batch = _data_rows(batch)
            split = data_splits(shardings or {})
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        num, den = zeros_like_acc(params)
        acc = (constrain(num), constrain(den))
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=state["step"].device)
        tier_loss = []
        for t in range(len(plans)):
            cp, masks = compress_with_masks(
                leaves, arrs["density"][t], arrs["e_bits"][t],
                arrs["m_bits"][t], out_dtype=cdt, shardings=shardings)
            tier_batch = {k: v[t] for k, v in batch.items()}
            if split:
                with parallel.regathering():
                    loss = model.loss_fn(Blocks(cp, split), tier_batch,
                                         num_groups=num_groups)
            else:
                loss = model.loss_fn(cp, tier_batch, num_groups=num_groups)
            grads = constrain(_grads(loss, leaves))
            num, den = accumulate_cohort(acc, grads, masks,
                                         arrs["weight"][t], 1.0)
            acc = (constrain(num), den)
            loss_sum = loss_sum + f32(arrs["weight"][t]) * loss.detach()
            tier_loss.append(loss.detach())
            del cp, masks, loss, grads      # one tier's buffers at a time
        losses = torch.cat([(loss_sum / wsum)[None], torch.stack(tier_loss)])
        dp = parallel.size(parallel.DATA)
        if dp > 1:       # an FSDP leaf's gradients are summed already
            acc = ({k: (v if k in split
                        else parallel.all_reduce(v, parallel.DATA))
                    / dp for k, v in acc[0].items()}, acc[1])
            losses = parallel.all_reduce(losses, parallel.DATA) / dp
        grads = finalize(acc)
        del acc, num, den
        new_params, new_opt = optimizer.update(grads, state["opt"], params,
                                               step=state["step"])
        new_state = dict(params=new_params, opt=new_opt,
                         step=state["step"] + 1)
        return new_state, {"loss": losses[0], "tier_loss": losses[1:]}

    return train_step


def make_fedsgd_train_step(model, optimizer, *, num_groups: int = 1):
    """Baseline: classic FedSGD (identical uncompressed local models) —
    the McMahan et al. comparison point."""
    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        leaves = {k: v.detach().requires_grad_()
                  for k, v in state["params"].items()}
        loss = model.loss_fn(leaves, batch, num_groups=num_groups)
        new_params, new_opt = optimizer.update(_grads(loss, leaves),
                                               state["opt"], state["params"],
                                               step=state["step"])
        return (dict(params=new_params, opt=new_opt, step=state["step"] + 1),
                {"loss": loss.detach()})

    return train_step


@torch.no_grad()
def compress_for_serving(params: dict, plan: CompressionPlan) -> dict:
    """One-time compression of the global model for deployment on a tier."""
    return compress_params(params, plan)[0]


def _serve_rows(batch: dict) -> tuple[dict, bool]:
    """(this data rank's rows of each leaf of a serve batch, the rows
    first; whether they split): over the data axes (``parallel.DATA``,
    row-major) where the batch divides over them, as the reference's
    setups split it (``launch.specs._batch_spec``), else the whole batch
    (replicated there)."""
    n, d = parallel.size(parallel.DATA), parallel.rank(parallel.DATA)
    rows = next(iter(batch.values())).shape[0]
    if n == 1 or rows % n:
        return batch, False
    return {k: v[d * rows // n:(d + 1) * rows // n]
            for k, v in batch.items()}, True


def _on_ranks(run, batch: dict):
    """``run(rows)`` on this rank's rows of ``batch`` (a whole batch
    replicated over the data axes where it does not divide: the layers
    then run as without them, ``parallel.rows_whole``), its logits
    gathered over the data axes whole on every rank, as the reference's
    setups return them (replicated)."""
    rows, split = _serve_rows(batch)
    with parallel.rows_whole(not split):
        logits, cache = run(rows)
    if split:
        logits = parallel.all_gather(logits, parallel.DATA, 0)
    return logits, cache


def make_serve_step(model, *, window: int = 0, num_groups: int = 1):
    """The decode step. On a mesh of several ranks (inside
    ``parallel.using``) ``params`` and ``cache`` are this rank's blocks
    (``param_spec_tree`` with no FSDP; ``cache_spec_tree``), ``tokens``
    (B, 1) the whole batch, of which the step takes this data rank's
    rows, and the logits come back whole on every rank."""
    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        if parallel.multi_rank():
            return _on_ranks(lambda rows: model.decode_step(
                params, cache, rows["tokens"], pos, window=window,
                num_groups=num_groups), {"tokens": tokens})
        return model.decode_step(params, cache, tokens, pos, window=window,
                                 num_groups=num_groups)
    return serve_step


def make_prefill_step(model, *, window: int = 0, num_groups: int = 1):
    """The prefill step. On a mesh of several ranks ``params`` are this
    rank's blocks, ``batch`` whole, of which the step takes this data
    rank's rows; the cache comes back as this rank's block
    (``cache_spec_tree``), the logits whole on every rank."""
    @torch.no_grad()
    def prefill_step(params, batch):
        if parallel.multi_rank():
            return _on_ranks(lambda rows: model.prefill(
                params, rows, window=window, num_groups=num_groups), batch)
        return model.prefill(params, batch, window=window,
                             num_groups=num_groups)
    return prefill_step
