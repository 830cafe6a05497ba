"""Port parity for the MoE family, on the CPU: the configs, ``capacity``
and ``_num_groups``, ``moe_apply`` (routing with ties, token-major
capacity drops, output, aux loss and gradients, in f32 and in bf16 with
checks that catch the bf16 rounding order going wrong), the MoE decoder's
forward, loss, prefill and decode, the compression of the expert leaves,
two tier-loop AdamW steps, decode against prefill, and train-state
checkpoints that cross between the packages. The reference's params
cross over through ``repro_torch.interop``; inputs come from numpy
seeds."""
import functools
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.core import compression as JC
from repro.core.steps import TrainState as JTrainState
from repro.core.steps import make_hetero_train_step as j_hetero_step
from repro.core.steps import make_prefill_step as j_prefill_step
from repro.core.steps import make_serve_step as j_serve_step
from repro.data.synthetic import make_train_batch as j_batch
from repro.launch import train as j_train_mod
from repro.models import decoder as JD
from repro.models import get_model as j_get_model
from repro.models import moe as JM
from repro_torch import optim as topt
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ShapeConfig, get_config, get_smoke_config
from repro_torch.core.compression import (DEVICE_TIERS, compress_params,
                                          compress_with_masks, compressible,
                                          default_tier_plans, magnitude_mask)
from repro_torch.core.steps import (make_hetero_train_step,
                                    make_prefill_step, make_serve_step)
from repro_torch.data.synthetic import make_train_batch
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train as train_mod
from repro_torch.models import decoder as TD
from repro_torch.models import get_model
from repro_torch.models import moe as TM

torch.set_num_threads(1)

ARCH = "granite-moe-1b-a400m"
MOE_ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@functools.lru_cache(maxsize=None)
def _moe_params(seed: int = 0):
    jp = JM.init_moe(jax.random.PRNGKey(seed), j_smoke(ARCH))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str, seed: int = 0):
    jp = JD.init(jax.random.PRNGKey(seed), j_smoke(arch))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b",
                                  "llava-next-34b"])
def test_configs_match_reference(arch):
    assert vars(get_config(arch)) == vars(j_config(arch))
    assert vars(get_smoke_config(arch)) == vars(j_smoke(arch))


# ------------------------------------------------------------- routing

@pytest.mark.parametrize("tokens,k,cf,e", [
    (4, 2, 1.25, 4),        # 2.5 -> 2: Python rounds halves to even
    (12, 2, 1.25, 4),       # 7.5 -> 8
    (4, 8, 1.25, 32),       # decode at batch 4: 1.25 -> 1
    (512, 8, 1.25, 32),     # granite-moe's full group: 160
    (256, 8, 1.25, 128),    # qwen3-moe's prefill group: 20
    (3, 1, 0.1, 64),        # floor of 1 slot
    (8, 4, 4.0, 2),         # cap at the group's tokens
])
def test_capacity_matches_reference(tokens, k, cf, e):
    cfg = j_smoke(ARCH).replace(experts_per_token=k, capacity_factor=cf,
                                num_experts=e)
    assert TM.capacity(tokens, cfg) == JM.capacity(tokens, cfg)
    if (tokens, k, cf, e) == (4, 2, 1.25, 4):
        assert TM.capacity(tokens, cfg) == 2


@pytest.mark.parametrize("n,num_groups", [
    (32, 1), (32, 2), (33, 2),      # 33 % 2 != 0: one group
    (2048, 1), (2048, 4), (1536, 1), (1000, 1), (8192, 16), (4, 1)])
def test_num_groups_matches_reference(n, num_groups):
    assert TM._num_groups(n, num_groups) == JM._num_groups(n, num_groups)
    if (n, num_groups) == (33, 2):
        assert TM._num_groups(n, num_groups) == 1


def test_route_breaks_ties_by_lower_index():
    """The reference's ``lax.top_k`` order: [1, 3, 3, 2, 3, 0] top-3 is
    experts [1, 2, 4]; ``torch.topk`` need not give that order."""
    logits = np.array([[1, 3, 3, 2, 3, 0], [0, 0, 0, 0, 5, 0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(logits), 3)
    tv, ti = TM.route(_t(logits), 3)
    assert ti.tolist() == np.asarray(ji).tolist() == [[1, 2, 4], [4, 0, 1]]
    assert np.array_equal(tv.numpy(), np.asarray(jv))


def _moe_case(cf: float, num_groups: int, tie: bool = False):
    """(reference out, aux; port out, aux) on a (2, 16, D) input at the
    f32 smoke config."""
    jp, tp = _moe_params()
    if tie:
        # experts 1 and 2 get the same router column: every token ties
        # them, at the k-th place wherever expert 0 or 3 leads
        w = np.asarray(jp["router"]["w"]).copy()
        w[:, 2] = w[:, 1]
        jp = {**jp, "router": {"w": jnp.asarray(w)}}
        tp = {**tp, "router.w": _t(w)}
    cfg = j_smoke(ARCH).replace(capacity_factor=cf)
    tcfg = get_smoke_config(ARCH).replace(capacity_factor=cf)
    x = _rand(3, 2, 16, cfg.d_model)
    jy, ja = jax.jit(functools.partial(JM.moe_apply, cfg=cfg,
                                       num_groups=num_groups))(
        jp, jnp.asarray(x))
    ty, ta = TM.moe_apply(tp, _t(x), tcfg, num_groups)
    return np.asarray(jy), float(ja), ty.numpy(), ta.item()


@pytest.mark.parametrize("cf", [2.0, 0.5])
@pytest.mark.parametrize("num_groups", [1, 2])
def test_moe_apply_matches_reference(num_groups, cf):
    """Output at rtol/atol 1e-5 and aux at 1e-6 on the f32 smoke config;
    at capacity factor 0.5 choices are dropped (a wrong drop moves an
    output row by O(1))."""
    jy, ja, ty, ta = _moe_case(cf, num_groups)
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_allclose(ta, ja, rtol=1e-6, atol=1e-6)
    full, _, _, _ = _moe_case(2.0, num_groups)
    moved = np.abs(full - jy).max(axis=-1)
    if cf < 1:
        assert (moved > 1e-3).any()          # choices were dropped
    else:
        assert (moved == 0).all()            # dropless at the smoke factor


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_moe_router_tie_at_kth_place(cf):
    jy, ja, ty, ta = _moe_case(cf, 1, tie=True)
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_allclose(ta, ja, rtol=1e-6, atol=1e-6)


def test_moe_grads_match_reference():
    """Gradients of a scalar of the output plus the aux loss with respect
    to every leaf and to x, at rtol 1e-4, with choices dropped."""
    jp, tp = _moe_params()
    cfg = j_smoke(ARCH).replace(capacity_factor=0.5)
    tcfg = get_smoke_config(ARCH).replace(capacity_factor=0.5)
    x, r = _rand(4, 2, 16, cfg.d_model), _rand(5, 2, 16, cfg.d_model)

    def j_obj(p, x):
        y, aux = JM.moe_apply(p, x, cfg)
        return jnp.sum(y * r) + aux
    jg, jgx = jax.jit(jax.grad(j_obj, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = _t(x).clone().requires_grad_()
    y, aux = TM.moe_apply(leaves, tx, tcfg)
    (torch.sum(y * _t(r)) + aux).backward()
    for name, g in params_from_numpy(jax.tree.map(np.asarray, jg)).items():
        np.testing.assert_allclose(leaves[name].grad.numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-6)


# ------------------------------------------------------------- bf16

BF16 = dict(dtype="bfloat16", num_experts=8, experts_per_token=4)


def _bf16_inputs(cf: float):
    """(reference cfg, port cfg, params, bf16 x as f32 numpy, cotangent)
    at 8 experts top-4, so each output row sums 4 expert outputs. x >= 1
    and ``we_g`` >= 0.25 put every hidden pre-activation above 30, where
    silu is the identity in bf16 in both packages (elsewhere the
    reference's bf16 sigmoid on the CPU is its own approximation): the
    expert products then agree bitwise, and what is left to compare is
    the dispatch, the drops, the combine and their gradients."""
    cfg = j_smoke(ARCH).replace(capacity_factor=cf, **BF16)
    tcfg = get_smoke_config(ARCH).replace(capacity_factor=cf, **BF16)
    jp = JM.init_moe(jax.random.PRNGKey(0), cfg)
    jp["we_g"] = jnp.asarray(
        0.25 + 0.1 * np.abs(_rand(7, *jp["we_g"].shape)))
    x = 1.0 + 0.5 * np.abs(_rand(3, 2, 16, cfg.d_model))
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return cfg, tcfg, jp, x, _rand(5, 2, 16, cfg.d_model)


@functools.lru_cache(maxsize=None)
def _bf16_reference(cf: float):
    """The reference's bf16 output, aux loss and gradients of
    ``sum(y * r) + aux`` with respect to every leaf and to x."""
    cfg, _, jp, x, r = _bf16_inputs(cf)

    def obj(p, x):
        y, aux = JM.moe_apply(p, x, cfg)
        return jnp.sum(y.astype(jnp.float32) * r) + aux, (y, aux)
    (_, (y, aux)), (g, gx) = jax.jit(jax.value_and_grad(
        obj, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x, jnp.bfloat16))
    f32 = functools.partial(np.asarray, dtype=np.float32)
    grads = {k: v.numpy() for k, v in params_from_numpy(
        jax.tree.map(f32, g)).items()}
    return f32(y), float(aux), f32(gx), grads


def _bf16_quanta(out, ref):
    """The largest |out - ref| in units of ref's bf16 quantum (the spacing
    of bf16 values at each element of ref)."""
    _, ex = np.frexp(ref)
    return float((np.abs(out - ref) / np.ldexp(1.0, ex - 8)).max())


def _bf16_errors(cf: float) -> dict:
    """The port's bf16 ``moe_apply`` against the reference's: bf16 quanta
    for the output, x's gradient and the bf16-cast expert leaves'
    gradients; relative error for the aux loss and the f32 router's
    gradient."""
    _, tcfg, jp, x, r = _bf16_inputs(cf)
    jy, ja, jgx, jg = _bf16_reference(cf)
    leaves = {k: v.clone().requires_grad_() for k, v in
              params_from_numpy(jax.tree.map(np.asarray, jp)).items()}
    tx = _t(x).to(torch.bfloat16).requires_grad_()
    y, aux = TM.moe_apply(leaves, tx, tcfg)
    (torch.sum(y.float() * _t(r)) + aux).backward()
    errs = {"y": _bf16_quanta(y.detach().float().numpy(), jy),
            "x.grad": _bf16_quanta(tx.grad.float().numpy(), jgx),
            "aux": abs(aux.item() - ja) / abs(ja)}
    for name in ("we_g", "we_i", "we_o"):
        errs[name] = _bf16_quanta(leaves[name].grad.numpy(), jg[name])
    g = jg["router.w"]
    errs["router.w"] = float(np.abs(leaves["router.w"].grad.numpy() - g)
                             .max() / np.abs(g).max())
    return errs


def _within_bf16(errs: dict) -> bool:
    """Output and bf16 gradients within one bf16 quantum of each element;
    the aux loss and the router's f32 gradient within 1e-5 relative."""
    return all(errs[k] <= 1.0 for k in ("y", "x.grad", "we_g", "we_i",
                                        "we_o")) \
        and errs["aux"] <= 1e-5 and errs["router.w"] <= 1e-5


@pytest.mark.parametrize("cf", [1.0, 2.0])
def test_moe_apply_bf16_matches_reference(cf):
    """In bf16 with 4 choices a token, at a factor that drops choices
    (1.0) and one that drops none (2.0): gates rounded to bf16 before the
    combine, the k products summed in f32 and rounded once, and each
    token's gradient summed over its k slots in f32 and rounded once, as
    the reference's bf16 einsums with f32 accumulation do."""
    errs = _bf16_errors(cf)
    assert _within_bf16(errs), errs
    jy = _bf16_reference(cf)[0]
    dropped = (np.abs(jy).max(-1) == 0).any()
    assert dropped == (cf < 2.0)


def _combine_unrounded_gates(picked, gates, dt):
    return torch.einsum("nkd,nk->nd", picked.float(), gates).to(dt)


def _combine_in_bf16(picked, gates, dt):
    w = gates.to(dt)
    y = picked[:, 0] * w[:, :1]
    for i in range(1, w.shape[1]):
        y = y + picked[:, i] * w[:, i:i + 1]
    return y


def _sum_slots_in_bf16(rows):
    y = rows[:, 0]
    for i in range(1, rows.shape[1]):
        y = y + rows[:, i]
    return y


@pytest.mark.parametrize("name,fn", [
    ("_combine", _combine_unrounded_gates),
    ("_combine", _combine_in_bf16),
    ("_sum_slots", _sum_slots_in_bf16)],
    ids=["gates_unrounded", "combine_in_bf16", "backward_in_bf16"])
def test_moe_apply_bf16_check_catches(monkeypatch, name, fn):
    """The bf16 check fails the port with the gates left unrounded, with
    the k choices summed in bf16, or with the gather's backward summing a
    token's k slots in bf16."""
    monkeypatch.setattr(TM, name, fn)
    assert not _within_bf16(_bf16_errors(1.0))


# ------------------------------------------------------------- decoder

def test_moe_param_leaves_match_reference():
    """The same 12 stacked leaves under the same names, order and shapes;
    the experts are 4-D (L, E, D, F)."""
    for arch in MOE_ARCHS:
        _, tp = _ref_params(arch)
        mine = TD.init(0, get_smoke_config(arch), device="cpu")
        assert list(mine) == list(tp)
        assert {k: tuple(v.shape) for k, v in mine.items()} == \
            {k: tuple(v.shape) for k, v in tp.items()}
    cfg = get_smoke_config(ARCH)
    assert tuple(tp["layers.moe.we_g"].shape) == (
        cfg.num_layers, cfg.num_experts, cfg.d_model, cfg.d_ff)
    assert tuple(tp["layers.moe.router.w"].shape) == (
        cfg.num_layers, cfg.d_model, cfg.num_experts)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_and_loss_match_reference(arch, use_flash):
    """Logits, the summed aux loss and the loss at rtol/atol 1e-5."""
    jcfg = j_smoke(arch).replace(use_flash=use_flash)
    tcfg = get_smoke_config(arch).replace(use_flash=use_flash)
    jp, tp = _ref_params(arch)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             (2, 17)).astype(np.int32)
    jl, ja = jax.jit(functools.partial(JD.forward, cfg=jcfg))(
        jp, jnp.asarray(toks[:, :-1]))
    jloss = jax.jit(functools.partial(JD.loss_fn, cfg=jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    tl, ta = TD.forward(tp, _t(toks[:, :-1]), tcfg)
    tloss = TD.loss_fn(tp, {"tokens": _t(toks)}, tcfg)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-6, atol=1e-6)
    assert float(ja) > 0
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_match_reference(arch):
    """Prefill's last-token logits and cache, then 4 decode steps' logits,
    at rtol/atol 1e-5 (decode at batch 2 groups 2 tokens)."""
    cfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    jp, tp = _ref_params(arch)
    model = get_model(tcfg)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             (2, 10)).astype(np.int32)
    jl, jcache = jax.jit(functools.partial(JD.prefill, cfg=cfg))(
        jp, jnp.asarray(toks[:, :6]))
    tl, tcache = model.prefill(tp, {"tokens": _t(toks[:, :6])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for key in ("k", "v", "slot_pos"):
        np.testing.assert_allclose(tcache["layers"][key].numpy(),
                                   np.asarray(jcache["layers"][key]), **TOL)
    j_decode = jax.jit(functools.partial(JD.decode_step, cfg=cfg))
    jc = JD.init_cache(cfg, 2, 10)
    tc = model.init_cache(2, 10, device="cpu")
    for i in range(10):
        a, jc = j_decode(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        b, tc = model.decode_step(tp, tc, _t(toks[:, i:i + 1]), i)
        if i >= 6:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("num_groups", [1, 2])
def test_moe_num_groups_through_steps(num_groups):
    """``num_groups`` passes from ``make_prefill_step`` and
    ``make_serve_step`` through the model to every MoE layer, as in the
    reference: at capacity factor 0.5 choices are dropped, so the
    grouping moves the logits, and both packages move them alike
    (rtol/atol 1e-5)."""
    cfg = j_smoke(ARCH).replace(capacity_factor=0.5)
    tcfg = get_smoke_config(ARCH).replace(capacity_factor=0.5)
    jp, tp = _ref_params(ARCH)
    jm, tm = j_get_model(cfg), get_model(tcfg)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                             (4, 8)).astype(np.int32)
    logits = {}
    for g in sorted({1, num_groups}):
        jl, _ = jax.jit(j_prefill_step(jm, num_groups=g))(
            jp, {"tokens": jnp.asarray(toks)})
        tl, _ = make_prefill_step(tm, num_groups=g)(tp, {"tokens": _t(toks)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        logits[g] = tl
    if num_groups > 1:
        assert not torch.equal(logits[1], logits[num_groups])
    j_decode = jax.jit(j_serve_step(jm, num_groups=num_groups))
    t_decode = make_serve_step(tm, num_groups=num_groups)
    jc, tc = JD.init_cache(cfg, 4, 8), tm.init_cache(4, 8, device="cpu")
    for i in range(4):
        a, jc = j_decode(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        b, tc = t_decode(tp, tc, _t(toks[:, i:i + 1]), i)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_replay_matches_forward(arch):
    """The reference's tests/test_decode_consistency.py on the port:
    replaying 12 tokens through decode_step gives the full forward's
    last-token logits at rtol/atol 2e-4 (the smoke factor 2.0 drops
    nothing at either grouping)."""
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    params = model.init(7, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    full, _ = TD.forward(params, toks, cfg)
    cache = model.init_cache(2, 12, device="cpu")
    for i in range(12):
        logits, cache = model.decode_step(params, cache, toks[:, i:i + 1], i)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-4, atol=2e-4)


# --------------------------------------------------------- compression

def test_moe_compression_matches_reference():
    """The router stays f32 and unmasked (scalar mask 1); each 4-D expert
    leaf gets ONE pruning threshold over the whole stacked leaf (its
    kept fraction is the tier's density over the leaf, not per layer or
    expert); the masks equal the reference's; the quantized leaves are
    the reference's compressible ones (10 of 12, all but final_norm and
    the router)."""
    jp, tp = _ref_params(ARCH)
    plan = JC.DEVICE_TIERS["low"]
    _, jm = jax.jit(JC.compress_params, static_argnums=1)(jp, plan)
    tc, tm = compress_params(tp, DEVICE_TIERS["low"])
    jm = params_from_numpy(jax.tree.map(np.asarray, jm))
    n_ref = sum(JC.compressible(p, x) for p, x in
                jax.tree_util.tree_flatten_with_path(jp)[0])
    mine = [k for k, v in tp.items() if compressible(k, v)]
    assert len(mine) == n_ref == 10
    assert "layers.moe.router.w" not in mine
    assert torch.equal(tc["layers.moe.router.w"], tp["layers.moe.router.w"])
    assert tm["layers.moe.router.w"].dim() == 0
    for name in tm:
        assert np.array_equal(tm[name].numpy(), jm[name].numpy()), name
    for name in ("layers.moe.we_g", "layers.moe.we_i", "layers.moe.we_o"):
        m = magnitude_mask(tp[name], plan.density)
        assert torch.equal(m, tm[name])
        aw = tp[name].abs()
        assert aw[m == 1].min() >= aw[m == 0].max(), name   # one cut
        assert abs(m.mean().item() - plan.density) < 0.01, name
        # a threshold per layer and expert would keep other weights
        assert not torch.equal(magnitude_mask(tp[name], plan.density, 2), m)
    # the train step's compression: same masks, one kernel-path rounding
    # per compressible leaf
    _, masks = compress_with_masks(tp, plan.density, *plan.quant_em())
    assert all(torch.equal(masks[k], tm[k]) for k in tm)


# --------------------------------------------------------------- train

def test_moe_hetero_train_steps_match_reference():
    """Two tier-loop steps under AdamW(warmup_cosine(3e-4, 1, 2)) with
    flash attention on granite-moe's smoke config: mean losses and each
    tier's at rtol 1e-4; params after the two steps at atol 1e-5, each
    leaf moved by the updates."""
    jcfg = j_smoke(ARCH).replace(use_flash=True)
    tcfg = get_smoke_config(ARCH).replace(use_flash=True)
    jo = jopt.adamw(jopt.warmup_cosine(3e-4, 1, 2))
    to = topt.adamw(topt.warmup_cosine(3e-4, 1, 2))
    jstep = jax.jit(j_hetero_step(j_get_model(jcfg), jo,
                                  JC.default_tier_plans(4)))
    tstep = make_hetero_train_step(get_model(tcfg), to,
                                   default_tier_plans(4))
    jp, tp = _ref_params(ARCH)
    js = dict(params=jp, opt=jo.init(jp), step=jnp.zeros((), jnp.int32))
    ts = dict(params=tp, opt=to.init(tp),
              step=torch.zeros((), dtype=torch.int32))
    for i in range(2):
        shape = dict(n_tiers=4, seed=3, index=i)
        b = make_train_batch(tcfg, ShapeConfig("t", 16, 8, "train"), **shape)
        jb = j_batch(jcfg, JShape("t", 16, 8, "train"), **shape)
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, b)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4)
        assert tm["tier_loss"].shape == (4,)
    jflat = params_from_numpy(jax.tree.map(np.asarray, js["params"]))
    for name, a in jflat.items():
        np.testing.assert_allclose(ts["params"][name].numpy(), a.numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
        assert not torch.equal(ts["params"][name], tp[name]), name


# --------------------------------------------------------- checkpoints

CKPT_ARGS = ["--arch", ARCH, "--smoke", "--batch", "4", "--seq", "16",
             "--warmup", "2", "--log-every", "1", "--ckpt-every", "2"]


@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    """The reference's train launcher on granite-moe's smoke config, 4
    steps with a checkpoint every 2."""
    d = str(tmp_path_factory.mktemp("ref_ckpt"))
    argv = sys.argv
    sys.argv = ["train", *CKPT_ARGS, "--steps", "4", "--ckpt-dir", d]
    try:
        j_train_mod.main()
    finally:
        sys.argv = argv
    return d


def _port_state(cfg):
    model = get_model(cfg)
    opt = topt.adamw(topt.warmup_cosine(3e-4, 2, 4))
    params = model.init(0, device="cpu")
    return dict(params=params, opt=opt.init(params),
                step=torch.zeros((), dtype=torch.int32))


def test_moe_reference_checkpoint_resumes_in_port(ref_ckpt, tmp_path):
    """The reference's step-2 checkpoint resumes in the port's launcher,
    whose steps 3-4 land within atol 1e-5 of the reference's step-4
    checkpoint, as in the train-step test."""
    d = str(tmp_path / "ckpt")
    os.makedirs(d)
    for f in os.listdir(ref_ckpt):
        if "00000002" in f:
            shutil.copy(os.path.join(ref_ckpt, f), d)
    res = train_mod.main([*CKPT_ARGS, "--steps", "4", "--ckpt-dir", d,
                          "--device", "cpu"])
    assert res["start"] == 2 and len(res["losses"]) == 2
    cfg = get_smoke_config(ARCH)
    ref4, step = Checkpointer(ref_ckpt).restore(_port_state(cfg), step=4)
    assert step == 4 and int(res["state"]["step"]) == 4
    for name, a in ref4["params"].items():
        np.testing.assert_allclose(res["state"]["params"][name].numpy(),
                                   a.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


def test_moe_port_checkpoint_loads_in_reference(tmp_path):
    """A checkpoint of the port's launcher restores in the reference's
    Checkpointer with every param, both AdamW moments and the step
    bitwise."""
    d = str(tmp_path / "ckpt")
    res = train_mod.main([*CKPT_ARGS, "--steps", "2", "--ckpt-dir", d,
                          "--device", "cpu"])
    cfg = j_smoke(ARCH)
    model = j_get_model(cfg)
    opt = jopt.adamw(jopt.warmup_cosine(3e-4, 2, 2))
    tmpl = JTrainState.create(model, opt, jax.random.PRNGKey(1))
    state, step = JCheckpointer(d).restore(tmpl)
    assert step == 2 and int(state["step"]) == 2
    st = res["state"]
    for name, a in params_from_numpy(
            jax.tree.map(np.asarray, state["params"])).items():
        assert torch.equal(a, st["params"][name]), name
    for s in ("m", "v"):
        for name, a in params_from_numpy(
                jax.tree.map(np.asarray, state["opt"][s])).items():
            assert torch.equal(a, st["opt"][s][name]), (s, name)


def test_moe_kill_and_resume_is_bitwise(tmp_path, capsys):
    """A port run whose last checkpoint is step 2 resumes there: steps 3-4
    reproduce the uninterrupted run's losses and state bit for bit."""
    d = str(tmp_path / "ckpt")
    args = [*CKPT_ARGS, "--steps", "4", "--ckpt-dir", d, "--device", "cpu"]
    full = train_mod.main(args)
    os.remove(os.path.join(d, "ckpt_00000004.npz"))
    res = train_mod.main(args)
    assert "restored step 2" in capsys.readouterr().out
    assert res["start"] == 2 and res["losses"] == full["losses"][2:]
    assert res["tier_losses"] == full["tier_losses"][2:]
    a, b = full["state"], res["state"]
    assert all(torch.equal(a["params"][k], b["params"][k])
               for k in a["params"])
    assert all(torch.equal(a["opt"][s][k], b["opt"][s][k])
               for s in ("m", "v") for k in a["params"])
