"""Port parity for the LM serve and tier-loop train paths on the llama
smoke config, on the CPU: compression for serving, prefill and greedy
decode per device tier, and the hetero train step with flash attention
(first step's aggregated gradient, params under SGD, losses under
AdamW). The reference's params and batches cross over through numpy."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.core import compression as JC
from repro.core.compression.pruning import _threshold as j_threshold
from repro.core.steps import make_fedsgd_train_step as j_fedsgd_step
from repro.core.steps import make_hetero_train_step as j_hetero_step
from repro.data.synthetic import TokenStream as JStream
from repro.data.synthetic import make_train_batch as j_batch
from repro.models import decoder as JD
from repro.models import get_model as j_get_model
from repro_torch import optim as topt
from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.core.compression import (DEVICE_TIERS, compress_params,
                                          default_tier_plans, magnitude_mask)
from repro_torch.core.steps import (compress_for_serving,
                                    make_fedsgd_train_step,
                                    make_hetero_train_step, make_prefill_step,
                                    make_serve_step)
from repro_torch.data.synthetic import TokenStream, make_train_batch
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import get_model

torch.set_num_threads(1)

ARCH = "llama3.2-3b"
PROMPT, GEN = 12, 8
# llama3.2-3b's full width at one layer, with the smoke vocabulary
WIDE = dict(d_model=3072, d_ff=8192, num_heads=24, num_kv_heads=8,
            head_dim=128, num_layers=1)


@functools.lru_cache(maxsize=None)
def _params():
    jp = JD.init(jax.random.PRNGKey(0), j_smoke(ARCH))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _ulp(x):
    return np.spacing(np.abs(x).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _j_serve_fns():
    cfg = j_smoke(ARCH)
    prefill = jax.jit(functools.partial(JD.prefill, cfg=cfg))
    decode = jax.jit(functools.partial(JD.decode_step, cfg=cfg))
    return prefill, decode


@pytest.mark.parametrize("tier", list(DEVICE_TIERS))
def test_serve_matches_reference(tier):
    """compress_for_serving: masks equal but for a weight within 4 ulps
    of the reference threshold (XLA's and torch's exp differ by an ulp),
    values bitwise where the masks agree (the clustered tier to atol
    1e-6: its Lloyd update sums in another order). Then, on the
    reference's compressed params: prefill's last-token logits and cache
    at rtol/atol 1e-5, and 8 greedy decode tokens equal."""
    jp, tp = _params()
    plan_j = JC.DEVICE_TIERS[tier]
    jc, jm = jax.jit(JC.compress_params, static_argnums=1)(jp, plan_j)
    tc = compress_for_serving(tp, DEVICE_TIERS[tier])
    _, tm = compress_params(tp, DEVICE_TIERS[tier])
    for a, b, ma, mb, (name, w) in zip(_leaves(jc), tc.values(), _leaves(jm),
                                       tm.values(), tp.items()):
        b, mb = b.numpy(), mb.numpy()
        flip = np.broadcast_to(ma != mb, a.shape)
        if flip.any():
            thr = np.float32(j_threshold(jnp.abs(jnp.asarray(w.numpy())),
                                         plan_j.density))
            aw = np.abs(w.numpy())[flip]
            assert (np.abs(aw - thr) <= 4 * _ulp(thr)).all(), name
        if plan_j.cluster_k:
            np.testing.assert_allclose(b[~flip], a[~flip], rtol=0, atol=1e-6)
        else:
            assert np.array_equal(b[~flip], a[~flip]), name

    cfg = get_smoke_config(ARCH)
    model = get_model(cfg)
    prefill, decode = make_prefill_step(model), make_serve_step(model)
    j_prefill, j_decode = _j_serve_fns()
    cp = params_from_numpy(jax.tree.map(np.asarray, jc))
    prompt = JStream(cfg.vocab_size, 2, PROMPT, seed=1).batch_at(0)[
        "tokens"][:, :PROMPT]
    tprompt = TokenStream(cfg.vocab_size, 2, PROMPT, seed=1).batch_at(0)[
        "tokens"][:, :PROMPT]
    assert np.array_equal(tprompt.numpy(), np.asarray(prompt))
    jl, jcache = j_prefill(jc, prompt)
    tl, tcache = prefill(cp, {"tokens": tprompt})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    for key in ("k", "v", "slot_pos"):
        np.testing.assert_allclose(tcache["layers"][key].numpy(),
                                   np.asarray(jcache["layers"][key]),
                                   rtol=1e-5, atol=1e-5)

    jcache = JD.init_cache(j_smoke(ARCH), 2, PROMPT + GEN)
    tcache = model.init_cache(2, PROMPT + GEN, device="cpu")
    for i in range(PROMPT):
        _, jcache = j_decode(jc, jcache, prompt[:, i:i + 1], jnp.int32(i))
        _, tcache = decode(cp, tcache, tprompt[:, i:i + 1], i)
    jt = [jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]]
    tt = [torch.argmax(tl[:, -1], -1).to(torch.int32)[:, None]]
    for pos in range(PROMPT, PROMPT + GEN):
        a, jcache = j_decode(jc, jcache, jt[-1], jnp.int32(pos))
        b, tcache = decode(cp, tcache, tt[-1], pos)
        jt.append(jnp.argmax(a[:, -1], -1).astype(jnp.int32)[:, None])
        tt.append(torch.argmax(b[:, -1], -1).to(torch.int32)[:, None])
    assert np.array_equal(torch.cat(tt, 1).numpy(),
                          np.asarray(jnp.concatenate(jt, 1)))


def _record():
    """An optimizer that returns the aggregated gradient as the new
    params, in each package."""
    return (jopt.Optimizer(lambda p: (), lambda g, s, p, step=0: (g, s)),
            topt.Optimizer(lambda p: (), lambda g, s, p, step=0: (g, s)))


@functools.lru_cache(maxsize=None)
def _j_tier_losses():
    """The reference's loss of each tier's compressed model on its
    sub-batch, as its train step computes it inside the tier scan."""
    cfg = j_smoke(ARCH).replace(use_flash=True)
    model = j_get_model(cfg)
    arrs = JC.plan_arrays(JC.default_tier_plans(4))

    def f(params, tokens):
        return jnp.stack([model.loss_fn(JC.compress_with_masks(
            params, arrs["density"][t], arrs["e_bits"][t], arrs["m_bits"][t],
            out_dtype=jnp.dtype(cfg.dtype))[0], {"tokens": tokens[t]})
            for t in range(4)])
    return jax.jit(f)


def _train(opts, steps, tier_losses=False):
    """``steps`` hetero steps in both packages from the reference's init
    on the reference's batches (global batch 8, seq 16, 4 tiers,
    use_flash). Returns (params and losses) of each, and with
    ``tier_losses`` also each step's per-tier losses of each."""
    jcfg = j_smoke(ARCH).replace(use_flash=True)
    tcfg = get_smoke_config(ARCH).replace(use_flash=True)
    jopt_, topt_ = opts
    jstep = jax.jit(j_hetero_step(j_get_model(jcfg), jopt_,
                                  JC.default_tier_plans(4)))
    tstep = make_hetero_train_step(get_model(tcfg), topt_,
                                   default_tier_plans(4))
    jp, tp = _params()
    js = dict(params=jp, opt=jopt_.init(jp), step=jnp.zeros((), jnp.int32))
    ts = dict(params=tp, opt=topt_.init(tp),
              step=torch.zeros((), dtype=torch.int32))
    jl, tl, jtl, ttl = [], [], [], []
    for i in range(steps):
        b = make_train_batch(tcfg, ShapeConfig("t", 16, 8, "train"),
                             n_tiers=4, seed=3, index=i)
        jb = j_batch(jcfg, JShape("t", 16, 8, "train"), n_tiers=4, seed=3,
                     index=i)
        assert np.array_equal(b["tokens"].numpy(), np.asarray(jb["tokens"]))
        if tier_losses:
            jtl.append(np.asarray(_j_tier_losses()(js["params"],
                                                   jb["tokens"])))
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, b)
        jl.append(float(jm["loss"]))
        tl.append(tm["loss"].item())
        ttl.append(tm["tier_loss"].numpy())
    if tier_losses:
        return js["params"], ts["params"], jl, tl, jtl, ttl
    return js["params"], ts["params"], jl, tl


def test_train_step_aggregated_gradient_matches_reference():
    """The first step's finalize output at rtol 1e-4 / atol 1e-6: a
    gradient of the compressed model, so a weight near a quantization
    boundary may round differently (XLA's and torch's matmul sums
    differ in the last bits)."""
    jg, tg, jl, tl = _train(_record(), 1)
    for name, a in params_from_numpy(jax.tree.map(np.asarray, jg)).items():
        np.testing.assert_allclose(tg[name].numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_train_step_params_under_sgd_match_reference():
    """Params after 2 SGD steps at atol 1e-5."""
    jp, tp, _, _ = _train((jopt.sgd(0.5), topt.sgd(0.5)), 2)
    for a, b in zip(_leaves(jp), jax.tree.leaves(params_to_numpy(tp))):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def test_train_step_losses_under_adamw_match_reference():
    """The schedule of the train phase on the card,
    AdamW(warmup_cosine(3e-4, 2, 5)) over 5 steps: the mean losses and
    each tier's loss at rtol 1e-4. AdamW's sign-like first update
    amplifies ulp differences of near-zero gradients, so params are not
    compared bitwise. The updates un-tie the stacked norm scales
    layers.ln1/ln2 (all 1.0 at init, so all kept); the pruned tiers then
    drop part of them, in the reference as in the port: after 5 steps
    the low tier keeps about its density of them in both."""
    jp, tp, jl, tl, jtl, ttl = _train(
        (jopt.adamw(jopt.warmup_cosine(3e-4, 2, 5)),
         topt.adamw(topt.warmup_cosine(3e-4, 2, 5))), 5, tier_losses=True)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(np.stack(ttl), np.stack(jtl), rtol=1e-4)
    assert tl[-1] != tl[0]
    low = DEVICE_TIERS["low"].density
    for name in ("ln1", "ln2"):
        j_keep = float(JC.magnitude_mask(jp["layers"][name], low).mean())
        t_keep = magnitude_mask(tp[f"layers.{name}"], low).mean().item()
        assert j_keep < 0.5 and t_keep < 0.5, (name, j_keep, t_keep)
        assert abs(j_keep - t_keep) <= 0.05, (name, j_keep, t_keep)


def test_fedsgd_train_step_matches_reference():
    """The uncompressed FedSGD baseline: one SGD step, loss at rtol 1e-5
    and params at atol 1e-5."""
    jcfg, tcfg = j_smoke(ARCH), get_smoke_config(ARCH)
    jp, tp = _params()
    b = make_train_batch(tcfg, ShapeConfig("t", 16, 4, "train"), seed=4)
    jstep = jax.jit(j_fedsgd_step(j_get_model(jcfg), jopt.sgd(0.5)))
    tstep = make_fedsgd_train_step(get_model(tcfg), topt.sgd(0.5))
    js, jm = jstep(dict(params=jp, opt=(), step=jnp.zeros((), jnp.int32)),
                   {"tokens": jnp.asarray(b["tokens"].numpy())})
    ts, tm = tstep(dict(params=tp, opt=(),
                        step=torch.zeros((), dtype=torch.int32)), b)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    for a, t in zip(_leaves(js["params"]),
                    jax.tree.leaves(params_to_numpy(ts["params"]))):
        np.testing.assert_allclose(t, a, rtol=0, atol=1e-5)


def test_adamw_loss_jump_at_full_width_matches_reference():
    """At llama3.2-3b's full width (one layer, the smoke vocabulary) the
    card's train schedule, AdamW(warmup_cosine(3e-4, 2, 5)), makes the
    loss jump after the first nonzero updates, in the reference as in the
    port. At the smoke width the same schedule makes no jump. Shown on
    the uncompressed FedSGD step over 3 steps: losses at rtol 1e-5, and
    step 3's loss above step 1's by more than 0.25 in both."""
    jcfg = j_smoke(ARCH).replace(**WIDE)
    tcfg = get_smoke_config(ARCH).replace(**WIDE)
    jp = JD.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    jo = jopt.adamw(jopt.warmup_cosine(3e-4, 2, 5))
    to = topt.adamw(topt.warmup_cosine(3e-4, 2, 5))
    jstep = jax.jit(j_fedsgd_step(j_get_model(jcfg), jo))
    tstep = make_fedsgd_train_step(get_model(tcfg), to)
    js = dict(params=jp, opt=jo.init(jp), step=jnp.zeros((), jnp.int32))
    ts = dict(params=tp, opt=to.init(tp),
              step=torch.zeros((), dtype=torch.int32))
    del jp, tp
    jl, tl = [], []
    for i in range(3):
        b = make_train_batch(tcfg, ShapeConfig("t", 16, 8, "train"), seed=3,
                             index=i)
        js, jm = jstep(js, {"tokens": jnp.asarray(b["tokens"].numpy())})
        ts, tm = tstep(ts, b)
        jl.append(float(jm["loss"]))
        tl.append(tm["loss"].item())
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert jl[2] > jl[0] + 0.25 and tl[2] > tl[0] + 0.25, (jl, tl)
