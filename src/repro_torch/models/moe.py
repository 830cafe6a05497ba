"""Top-k MoE layer with capacity-based expert dispatch, as the reference's
``models/moe.py``.

Routing is the reference's exactly: f32 router logits, the top-k experts
per token with the lower expert index first on ties (a stable sort;
``torch.topk`` does not keep that order), softmax gates over the top-k
values, the Switch load-balance loss over all k choices, and a capacity
per expert and group of <= ``GROUP`` tokens filled in token-major order
over the flattened (token, choice) list; a choice past capacity is
dropped and adds exactly 0.

The reference dispatches with one-hot (g, n, e, c) einsums, a form
GSPMD partitions over a mesh. One card has no mesh, so the port gathers
instead, which is exact in the same way (each capacity slot holds at
most one token): the tokens are gathered into an expert-major
(e, g * cap, d) buffer, the experts run as three batched products in
the compute dtype, and each token gathers back its k expert outputs and
sums them times its gates rounded to the compute dtype, in f32, rounded
once (the reference's bf16 einsum with f32 accumulation). The backward
of each gather is a gather too (``_RowGather``): a token's gradient sums
its k slots in f32, rounded once, as the einsum's transpose does, and
no scatter-add runs. The routing makes no host sync (no ``one_hot``,
whose range check reads the device).

Over a mesh of ranks (``models/parallel.py``) the experts may be split
over "model" (expert parallelism: ``we_*`` hold this rank's ``E / M``
experts, ``rank("model") * E / M`` the first) and the batch over the
data axes (``parallel.DATA``: "data", and "pod" where the mesh has one;
each rank its rows). The router is replicated: routing, the aux loss
and the capacity positions run on every model rank as on one. Each rank
gathers and runs only the slots of its experts; each token's f32 sum of
its local choices' ``gate * out`` is summed over "model" and rounded to
the compute dtype once. The groups, capacity and positions are those of
the whole batch: each choice's position comes from its whole group's
expert choices, gathered over the data axes, and the expert load
(``me``, ``ce``) is averaged over them before its product.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import parallel
from repro_torch.models.layers import init_dense

GROUP = 512          # max tokens per dispatch group


def init_moe(generator: torch.Generator, cfg) -> dict:
    """``router.w`` (D, E), ``we_g`` / ``we_i`` (E, D, F), ``we_o``
    (E, F, D), with the reference's scales."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    scale_in = 1.0 / math.sqrt(d)
    scale_out = 1.0 / math.sqrt(f * 2 * cfg.num_layers)

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=generator.device)
    return {
        "router.w": init_dense(generator, d, e, scale=0.02)["w"],
        "we_g": normal(e, d, f) * scale_in,
        "we_i": normal(e, d, f) * scale_in,
        "we_o": normal(e, f, d) * scale_out,
    }


def capacity(tokens_per_group: int, cfg) -> int:
    """Slots per expert and group. Python's ``round`` rounds halves to
    even, as in the reference (2.5 -> 2)."""
    c = int(round(tokens_per_group * cfg.experts_per_token
                  * cfg.capacity_factor / cfg.num_experts))
    return max(min(c, tokens_per_group), 1)


def _num_groups(n: int, num_groups: int) -> int:
    """Data-shard groups split further into <=GROUP-token subgroups."""
    g = num_groups if n % num_groups == 0 else 1
    per = n // g
    sub = max(1, per // GROUP)
    while per % sub:
        sub -= 1
    return g * sub


def route(logits: torch.Tensor, k: int):
    """(top-k values, top-k expert indices) over the last axis, the
    largest first and, among equal values, the lower index first
    (``lax.top_k``'s order)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class _RowGather(torch.autograd.Function):
    """``src`` (R, D) with a zero row appended, gathered at ``idx`` (each
    in [0, R]). ``back`` (R, m) lists for each source row the output rows
    that read it (the count of outputs, a zero row, where fewer): the
    backward gathers and sums those rows of the gradient, in f32 rounded
    once, in place of ``index_select``'s scatter-add (atomic, or sorted
    under deterministic algorithms, and summed in the gradient's
    dtype)."""

    @staticmethod
    def forward(src, idx, back):
        pad = torch.cat([src, src.new_zeros((1, src.shape[1]))])
        return pad.index_select(0, idx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[2])

    @staticmethod
    def backward(ctx, g):
        (back,) = ctx.saved_tensors
        pad = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        rows = pad.index_select(0, back.reshape(-1)).view(*back.shape, -1)
        if back.shape[1] == 1:
            return rows[:, 0], None, None
        return _sum_slots(rows), None, None


def _sum_slots(rows: torch.Tensor) -> torch.Tensor:
    """(R, m, D) -> (R, D): the sum over axis 1 in f32, rounded once to
    the rows' dtype."""
    return rows.to(torch.float32).sum(1).to(rows.dtype)


def _combine(picked: torch.Tensor, gates: torch.Tensor, dt) -> torch.Tensor:
    """(n, k, D) expert outputs and (n, k) f32 gates -> (n, D) in f32: the
    gates rounded to ``dt``, the k products summed in f32 (the caller
    rounds the sum to ``dt`` once)."""
    w = gates.to(dt).to(torch.float32)
    return torch.einsum("nkd,nk->nd", picked.to(torch.float32), w)


def moe_apply(p: dict, x: torch.Tensor, cfg, num_groups: int = 1, *,
              split: bool = False):
    """x: (B, T, D) -> (out (B, T, D), aux_loss scalar f32). ``p`` holds
    one layer's ``router.w``, ``we_g``, ``we_i`` and ``we_o``; ``split``:
    its ``we_*`` are this rank's block of the experts over "model". On a
    mesh whose data axes have several ranks, ``x`` is this rank's rows
    of the batch (``core.steps``), in rank order."""
    b, t, d = x.shape
    n = b * t
    e, k = cfg.num_experts, cfg.experts_per_token
    dp = parallel.size(parallel.DATA)
    g = _num_groups(n * dp, num_groups)       # of the whole batch
    ng = n * dp // g
    dt = getattr(torch, cfg.dtype)
    dev = x.device
    xg = x.reshape(g, ng, d) if dp == 1 else x.reshape(1, n, d)
    experts = torch.arange(e, device=dev)

    # --- routing (f32; the router is excluded from compression) ---
    logits = torch.matmul(xg.to(torch.float32),
                          p["router.w"].to(torch.float32))    # (g, ng, e)
    top_vals, top_idx = route(logits, k)                      # (g, ng, k)
    gates = torch.softmax(top_vals, dim=-1)

    # --- load-balance aux (Switch-style, over all top-k assignments) ---
    probs = torch.softmax(logits, dim=-1)
    me = torch.mean(probs, dim=(0, 1))                        # (e,)
    one_hot = top_idx[..., None] == experts                   # (g, ng, k, e)
    ce = torch.mean(torch.sum(one_hot.to(torch.float32), dim=2),
                    dim=(0, 1)) / k
    if dp > 1:          # the whole batch's load, before the product
        me = parallel.mean_over_data(me)
        ce = parallel.all_reduce(ce, parallel.DATA) / dp
    aux = cfg.router_aux_weight * e * torch.sum(me * ce)

    cap = capacity(ng, cfg)

    # --- position of each choice within its expert (token-major) ---
    if dp > 1:          # every group whole: the data ranks' choices
        whole = parallel.all_gather(top_idx.reshape(n, k),
                                    parallel.DATA, 0)
        whole = whole.view(g, ng * k)
        one_hot = whole[..., None] == experts
    else:
        whole = top_idx.reshape(g, ng * k)
    before = torch.cumsum(one_hot.reshape(g, ng * k, e).to(torch.int32),
                          dim=1)                              # (g, ng*k, e)
    pie = before.gather(-1, whole[..., None])[..., 0] - 1     # (g, ng*k)
    keep = pie < cap
    if dp > 1:          # this rank's choices (its rows'), in gl groups
        c0 = parallel.rank(parallel.DATA) * n * k     # first choice
        g0 = c0 // (ng * k)
        gl = (c0 + n * k - 1) // (ng * k) + 1 - g0
        flat = top_idx.reshape(n * k)
        pie = pie.reshape(-1)[c0:c0 + n * k]
        keep = keep.reshape(-1)[c0:c0 + n * k]
        grp = torch.arange(c0, c0 + n * k, device=dev) // (ng * k) - g0
    else:
        gl, flat = g, whole
        grp = torch.arange(g, device=dev)[:, None]
    el = p["we_g"].shape[0]
    if split:           # this rank's experts, from rank("model") * el
        e0 = parallel.rank("model") * el
        keep &= (flat >= e0) & (flat < e0 + el)
        flat = flat - e0

    # --- expert-major slots (el, gl, cap); a choice kept out has none ---
    n_slots = el * gl * cap
    slot = torch.where(keep, flat * (gl * cap) + grp * cap + pie, n_slots)
    # the choice in each slot, n * k (past the last) where the slot is
    # empty; choices kept out write past the slots, each to its own index
    choice = torch.arange(n * k, device=dev)
    slot_choice = torch.full((n_slots + n * k,), n * k, dtype=torch.int64,
                             device=dev)
    slot_choice.scatter_(
        0, torch.where(keep, slot, n_slots + choice.view(keep.shape))
        .reshape(-1), choice)
    slot_choice = slot_choice[:n_slots]

    # --- dispatch -> expert matmuls -> combine ---
    if split:           # each rank's part of x's and the gates' gradients
        x, gates = parallel.copy_to_model(x), parallel.copy_to_model(gates)
    buf = _RowGather.apply(x.reshape(n, d).to(dt), slot_choice // k,
                           slot.view(n, k)).view(el, gl * cap, d)
    hg = torch.bmm(buf, p["we_g"].to(dt))
    hi = torch.bmm(buf, p["we_i"].to(dt))
    out = torch.bmm(F.silu(hg) * hi, p["we_o"].to(dt)).reshape(n_slots, d)
    picked = _RowGather.apply(out, slot.reshape(-1),
                              slot_choice[:, None]).view(n, k, d)
    y = _combine(picked, gates.reshape(n, k), dt)
    if split:
        y = parallel.reduce_from_model(y)
    return y.to(dt).reshape(b, t, d).to(x.dtype), aux
