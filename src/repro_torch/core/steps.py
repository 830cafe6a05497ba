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

``make_serve_step`` / ``make_prefill_step`` run the model AS DEPLOYED on
a device tier, with params compressed once by ``compress_for_serving``.
"""
from __future__ import annotations

import torch

from repro_torch.core.aggregation import (accumulate_cohort, f32, finalize,
                                          zeros_like_acc)
from repro_torch.core.compression import (CompressionPlan, compress_params,
                                          compress_with_masks, plan_arrays)
from repro_torch.models.sharding import place


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


def make_hetero_train_step(model, optimizer, plans: list[CompressionPlan],
                           *, num_groups: int = 1, acc_shardings=None):
    """acc_shardings: optional NamedSharding dict (params-shaped). The
    gradients and the mask-aware accumulators are placed by it, as the
    reference constrains them (``models.sharding.place``: on a mesh of one
    device, the same tensors)."""
    arrs = plan_arrays(plans)
    wsum = float(sum(p.weight for p in plans))
    # compressed weights live in the model's compute dtype
    cdt = getattr(torch, model.cfg.dtype)

    def constrain(tree: dict) -> dict:
        if acc_shardings is None:
            return tree
        # rank-mismatched leaves (the scalar denominators of 1-D leaves)
        # stay as they are
        return place(tree, {k: acc_shardings[k]
                            if x.dim() == len(acc_shardings[k].spec) else None
                            for k, x in tree.items()})

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        num, den = zeros_like_acc(params)
        acc = (constrain(num), constrain(den))
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=state["step"].device)
        tier_loss = []
        for t in range(len(plans)):
            cp, masks = compress_with_masks(
                leaves, arrs["density"][t], arrs["e_bits"][t],
                arrs["m_bits"][t], out_dtype=cdt)
            loss = model.loss_fn(cp, {k: v[t] for k, v in batch.items()},
                                 num_groups=num_groups)
            grads = constrain(_grads(loss, leaves))
            num, den = accumulate_cohort(acc, grads, masks,
                                         arrs["weight"][t], 1.0)
            acc = (constrain(num), den)
            loss_sum = loss_sum + f32(arrs["weight"][t]) * loss.detach()
            tier_loss.append(loss.detach())
            del cp, masks, loss, grads      # one tier's buffers at a time
        grads = finalize(acc)
        del acc, num, den
        new_params, new_opt = optimizer.update(grads, state["opt"], params,
                                               step=state["step"])
        new_state = dict(params=new_params, opt=new_opt,
                         step=state["step"] + 1)
        return new_state, {"loss": loss_sum / wsum,
                           "tier_loss": torch.stack(tier_loss)}

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


def make_serve_step(model, *, window: int = 0, num_groups: int = 1):
    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos, window=window,
                                 num_groups=num_groups)
    return serve_step


def make_prefill_step(model, *, window: int = 0, num_groups: int = 1):
    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch, window=window,
                             num_groups=num_groups)
    return prefill_step
