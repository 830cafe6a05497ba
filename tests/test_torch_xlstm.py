"""Port parity for the xLSTM family (``models/xlstm.py``), on the CPU:
the config and leaf table, the causal conv, the chunked mLSTM cell, the
mLSTM and sLSTM layers (train form and decode form), the model's
forward, loss, gradients, prefill cache and decode, a bf16 forward, two
tier-loop AdamW steps, train-state checkpoints that cross between the
packages, and the one departure: the reference's gradients are NaN at
two chunks, the port's are finite and equal its own recurrent form's.

Tolerances. One chunk (T = 64): logits 1e-5, gradients rtol 1e-4.
Several chunks (T = 512): ``jnp.cumsum`` and ``torch.cumsum`` sum the
log forget gates in other orders, an ulp apart, and ``exp(cum)`` turns
that into |cum| ulps; with |cum| up to ~40 (forget gates near 1, so the
state carried across chunks matters) that is ~40 * 6e-8 = 2.4e-6
relative, so the multi-chunk checks use rtol/atol 5e-5. The reference's
params cross over through ``repro_torch.interop``; inputs come from
numpy seeds."""
import functools
import runpy

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
from repro.core.compression.pruning import magnitude_mask as j_mask
from repro.core.steps import make_hetero_train_step as j_hetero_step
from repro.data.synthetic import make_train_batch as j_batch
from repro.models import get_model as j_get_model
from repro.models import xlstm as JX
from repro_torch import optim as topt
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ShapeConfig, get_config, get_smoke_config
from repro_torch.core.compression import (compressible, default_tier_plans,
                                          magnitude_mask)
from repro_torch.core.steps import make_hetero_train_step
from repro_torch.data.synthetic import make_train_batch
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.models import xlstm as TX

torch.set_num_threads(1)

ARCH = "xlstm-1.3b"
TOL = dict(rtol=1e-5, atol=1e-5)
MULTI = dict(rtol=5e-5, atol=5e-5)      # several chunks: see the docstring


def _rand(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), err_msg=msg, **tol)


@functools.lru_cache(maxsize=None)
def _ref(layers: int = 2, dtype: str = "float32"):
    """(reference cfg, port cfg, reference params, the same as the port's
    name -> tensor dict) for the smoke config at ``layers`` layers."""
    jcfg = j_smoke(ARCH).replace(num_layers=layers, dtype=dtype)
    tcfg = get_smoke_config(ARCH).replace(num_layers=layers, dtype=dtype)
    jp = JX.init(jax.random.PRNGKey(layers), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _tokens(seed, b, t, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def _layer(tp, kind: str, s: int = 0, i: int = 0) -> dict:
    """One layer's view of the port's stacked params."""
    sub = TL.subtree(tp, f"blocks.{kind}.")
    return {k: v[s, i] if kind == "mlstm" else v[s] for k, v in sub.items()}


def _j_layer(jp, kind: str, s: int = 0, i: int = 0):
    sel = (s, i) if kind == "mlstm" else (s,)
    return jax.tree.map(lambda a: a[sel], jp["blocks"][kind])


# ------------------------------------------------------------- config

def test_config_and_registry():
    """The smoke and full configs are the reference's; ``get_model``
    serves the family."""
    assert vars(get_smoke_config(ARCH)) == vars(j_smoke(ARCH))
    assert vars(get_config(ARCH)) == vars(j_config(ARCH))
    model = get_model(get_smoke_config(ARCH))
    assert model.init.func is TX.init and model.cfg.family == "ssm"


def test_full_leaf_table_matches_reference():
    """chip_smoke.py's leaf table of the full config (the shapes its
    fake_quant checks run on) is ``jax.eval_shape`` of the reference's
    init: 19 leaves, 18 compressible in both packages, 3,530,676,560
    params, ``blocks.mlstm.qkv.w`` (6, 7, 4096, 12288) and the 5-D
    ``blocks.slstm.r_gates``."""
    cfg = j_config(ARCH)
    shapes = jax.eval_shape(lambda k: JX.init(k, cfg), jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    ref = {".".join(str(getattr(k, "key", k)) for k in path): tuple(x.shape)
           for path, x in flat}
    smoke = runpy.run_path("chip_smoke.py", run_name="chip_smoke")
    table = smoke["_lm_leaf_shapes"](get_config(ARCH))
    assert list(table.items()) == list(ref.items())
    n_ref = sum(JC.compressible(p, x) for p, x in flat)
    mine = [k for k, s in table.items()
            if compressible(k, torch.empty(s, device="meta"))]
    assert len(table) == 19 and len(mine) == n_ref == 18
    assert smoke["_n_compressible"](get_config(ARCH)) == 18
    assert sum(int(np.prod(s)) for s in table.values()) == 3_530_676_560
    assert table["blocks.mlstm.qkv.w"] == (6, 7, 4096, 12288)
    assert table["blocks.slstm.r_gates"] == (6, 4, 4, 512, 512)


@pytest.mark.parametrize("layers", [2, 4])
def test_param_leaves_match_reference(layers):
    """The port's init gives the reference's leaves: names in its flatten
    order and shapes, at one and two superblocks."""
    _, tcfg, _, tp = _ref(layers)
    mine = TX.init(0, tcfg, device="cpu")
    assert list(mine) == list(tp)
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in tp.items()}


# ------------------------------------------------------ per function

@pytest.mark.parametrize("t", [2, 64])
def test_causal_conv_matches_reference(t):
    """``causal_conv`` against ``_mlstm_conv`` (f32, rtol/atol 1e-5), and
    ``causal_conv_step`` over the rolling window, which the reference's
    decode uses, gives the same outputs step by step."""
    jcfg, _, jp, tp = _ref()
    lp, jl = _layer(tp, "mlstm"), _j_layer(jp, "mlstm")
    jl = {**jl, "conv_b": jnp.asarray(_rand(3, *jl["conv_b"].shape))}
    x = _rand(1, 2, t, lp["conv_w"].shape[0])
    ref = JX._mlstm_conv(jl, jnp.asarray(x), jcfg)
    conv_b = _t(jl["conv_b"])
    out = TL.causal_conv(_t(x), lp["conv_w"], conv_b)
    _close(out, ref, TOL)
    w1 = lp["conv_w"].shape[1] - 1
    window = torch.zeros((2, w1, x.shape[-1]))
    for s in range(t):
        window = torch.cat([window, _t(x[:, s:s + 1])], dim=1)
        step = TL.causal_conv_step(window, lp["conv_w"], conv_b)
        _close(step, out[:, s], TOL, f"step {s}")
        window = window[:, 1:]


def _cell_inputs(seed, t, b=2, h=4, hd=64):
    """q, k, v ~ N(0, 1); igate = sigmoid(N(0, 1)); forget gates near 1
    (log_sigmoid(N(3, 1))), so the state carried across chunks matters."""
    q, k, v = (_rand(seed + i, b, t, h, hd) for i in range(3))
    ig = 1.0 / (1.0 + np.exp(-_rand(seed + 3, b, t, h)))
    lf = -np.log1p(np.exp(-_rand(seed + 4, b, t, h, shift=3.0)))
    return q, k, v, ig.astype(np.float32), lf.astype(np.float32)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t", [64, 512])
def test_mlstm_cell_chunked_matches_reference(t, with_state):
    """``_mlstm_cell_chunked`` at one chunk (T = 64, 1e-5) and two (T =
    512, the multi-chunk tolerance): h and the final (C, n), from zeros
    or from a given state."""
    xs = _cell_inputs(0, t)
    state = ((_rand(9, 2, 4, 64, 64, scale=0.1), _rand(10, 2, 4, 64))
             if with_state else None)
    jh, (jc, jn) = jax.jit(JX._mlstm_cell_chunked)(
        *map(jnp.asarray, xs),
        None if state is None else tuple(map(jnp.asarray, state)))
    th, (tc, tn) = TX._mlstm_cell_chunked(
        *map(_t, xs), None if state is None else tuple(map(_t, state)))
    tol = TOL if t <= TX.CHUNK else MULTI
    for a, b, name in ((th, jh, "h"), (tc, jc, "C"), (tn, jn, "n")):
        _close(a, b, tol, name)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t", [64, 512])
def test_mlstm_forward_and_decode_match_reference(t, with_state):
    """``mlstm_forward`` (output, conv tail, C, n), from zeros or from a
    given state, then 4 ``mlstm_decode`` steps carried from its state."""
    jcfg, tcfg, jp, tp = _ref()
    lp, jl = _layer(tp, "mlstm"), _j_layer(jp, "mlstm")
    x = _rand(2, 2, t, jcfg.d_model)
    d_in, hd, _ = TX.dims(tcfg)
    st = None
    if with_state:
        st = {"mC": _rand(3, 2, 4, hd, hd, scale=0.1), "mn": _rand(4, 2, 4, hd)}
    jy, js = JX.mlstm_forward(jl, jnp.asarray(x), jcfg,
                              None if st is None else jax.tree.map(
                                  jnp.asarray, st))
    ty, ts = TX.mlstm_forward(lp, _t(x), tcfg,
                              None if st is None else jax.tree.map(_t, st))
    tol = TOL if t <= TX.CHUNK else MULTI
    _close(ty, jy, tol, "out")
    assert set(ts) == set(js) == {"conv", "mC", "mn"}
    for k in js:
        assert tuple(ts[k].shape) == js[k].shape
        _close(ts[k], js[k], tol, k)
    for i in range(4):
        xi = _rand(20 + i, 2, 1, jcfg.d_model)
        jy, js = JX.mlstm_decode(jl, jnp.asarray(xi), js, jcfg)
        ty, ts = TX.mlstm_decode(lp, _t(xi), ts, tcfg)
        _close(ty, jy, tol, f"decode {i}")
        for k in js:
            _close(ts[k], js[k], tol, f"decode {i} {k}")


def test_slstm_step_matches_reference():
    """One ``_slstm_step`` from a random state (rtol/atol 1e-5), with
    r_gates in f32 and (compressed for training) in bf16, whose product
    with the f32 state promotes to f32 as JAX's einsum does."""
    jcfg, tcfg, jp, tp = _ref()
    sp, jl = _layer(tp, "slstm"), _j_layer(jp, "slstm")
    hds = jcfg.d_model // jcfg.num_heads
    gx = _rand(5, 2, 4, jcfg.num_heads, hds)
    st = tuple(_rand(6 + i, 2, jcfg.num_heads, hds) for i in range(3))
    st = (st[0], np.abs(st[1]), st[2])
    for dt in (jnp.float32, jnp.bfloat16):
        jr = {**jl, "r_gates": jl["r_gates"].astype(dt)}
        tr = {**sp, "r_gates": _t(np.asarray(jr["r_gates"]).astype(
            np.float32)).to(getattr(torch, jnp.dtype(dt).name))}
        ref = JX._slstm_step(jr, jnp.asarray(gx), tuple(map(jnp.asarray, st)),
                             jcfg)
        out = TX._slstm_step(tr, _t(gx), tuple(map(_t, st)), tcfg)
        for a, b in zip(out, ref):
            assert a.dtype == torch.float32
            _close(a, b, TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t", [64, 512])
def test_slstm_forward_and_decode_match_reference(t, with_state):
    """``slstm_forward`` (the loop over T) from zeros or a given state,
    then 4 ``slstm_decode`` steps carried from its state."""
    jcfg, tcfg, jp, tp = _ref()
    sp, jl = _layer(tp, "slstm"), _j_layer(jp, "slstm")
    hds = jcfg.d_model // jcfg.num_heads
    x = _rand(7, 2, t, jcfg.d_model)
    st = None
    if with_state:
        st = (_rand(8, 2, 4, hds), np.abs(_rand(9, 2, 4, hds)),
              _rand(10, 2, 4, hds))
    jy, js = jax.jit(lambda p, x, s: JX.slstm_forward(p, x, jcfg, s))(
        jl, jnp.asarray(x), None if st is None else tuple(map(jnp.asarray,
                                                                st)))
    ty, ts = TX.slstm_forward(sp, _t(x), tcfg,
                              None if st is None else tuple(map(_t, st)))
    tol = TOL if t <= TX.CHUNK else MULTI
    _close(ty, jy, tol, "out")
    for k in ("sc", "sn", "sh"):
        _close(ts[k], js[k], tol, k)
    for i in range(4):
        xi = _rand(30 + i, 2, 1, jcfg.d_model)
        jy, js = JX.slstm_decode(jl, jnp.asarray(xi), js, jcfg)
        ty, ts = TX.slstm_decode(sp, _t(xi), ts, tcfg)
        _close(ty, jy, tol, f"decode {i}")


# ------------------------------------------------------------ model

def _j_loss(cfg):
    return jax.jit(jax.value_and_grad(
        lambda p, toks: JX.loss_fn(p, {"tokens": toks}, cfg)))


def _t_loss_and_grads(tp, toks, cfg):
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    loss = TX.loss_fn(leaves, {"tokens": _t(toks)}, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, dict(zip(leaves, grads))


@pytest.mark.parametrize("layers", [2, 4])
def test_forward_loss_and_grads_match_reference(layers):
    """One chunk (T = 64): logits and loss at rtol/atol 1e-5, every
    gradient at rtol 1e-4 (atol 1e-6), at one and two superblocks."""
    jcfg, tcfg, jp, tp = _ref(layers)
    toks = _tokens(1, 2, 65, jcfg.vocab_size)
    jl, _ = jax.jit(lambda p, x: JX.forward(p, x, jcfg, remat=False))(
        jp, jnp.asarray(toks[:, :-1]))
    tl, _ = TX.forward(tp, _t(toks[:, :-1]), tcfg)
    _close(tl, jl, TOL, "logits")
    jloss, jg = _j_loss(jcfg)(jp, jnp.asarray(toks))
    tloss, tg = _t_loss_and_grads(tp, toks, tcfg)
    _close(tloss, jloss, TOL, "loss")
    for name, a in params_from_numpy(jax.tree.map(np.asarray, jg)).items():
        np.testing.assert_allclose(tg[name].numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_forward_multi_chunk_matches_reference():
    """T = 512 (two chunks per mLSTM layer) at two superblocks: logits at
    the multi-chunk tolerance."""
    jcfg, tcfg, jp, tp = _ref(4)
    toks = _tokens(2, 1, 512, jcfg.vocab_size)
    jl, _ = jax.jit(lambda p, x: JX.forward(p, x, jcfg, remat=False))(
        jp, jnp.asarray(toks))
    tl, _ = TX.forward(tp, _t(toks), tcfg)
    _close(tl, jl, MULTI)


@pytest.mark.parametrize("t", [64, 512])
def test_prefill_cache_and_decode_match_reference(t):
    """``prefill``'s last-token logits and every cache leaf (the names,
    shapes and dtypes of the reference's ``init_cache``), then 8
    ``decode_step``s carried through the cache (written in place), at two
    superblocks."""
    jcfg, tcfg, jp, tp = _ref(4)
    model = get_model(tcfg)
    toks = _tokens(3, 2, t + 8, jcfg.vocab_size)
    jl, jc = jax.jit(lambda p, x: JX.prefill(p, x, jcfg))(
        jp, jnp.asarray(toks[:, :t]))
    tl, tc = model.prefill(tp, {"tokens": _t(toks[:, :t])})
    tol = TOL if t <= TX.CHUNK else MULTI
    _close(tl, jl, tol, "prefill logits")
    empty = jax.tree.map(np.asarray, JX.init_cache(jcfg, 2, 0))
    mine = model.init_cache(2, 0, device="cpu")
    for part in ("mlstm", "slstm"):
        assert set(tc[part]) == set(jc[part]) == set(empty[part]) == \
            set(mine[part])
        for k in jc[part]:
            assert tuple(tc[part][k].shape) == jc[part][k].shape == \
                empty[part][k].shape == tuple(mine[part][k].shape)
            assert str(mine[part][k].dtype).removeprefix("torch.") == \
                str(empty[part][k].dtype)
            _close(tc[part][k], jc[part][k], tol, f"{part}.{k}")
    j_decode = jax.jit(lambda p, c, x, i: JX.decode_step(p, c, x, i, jcfg))
    for i in range(t, t + 8):
        a, jc = j_decode(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        b, tc2 = model.decode_step(tp, tc, _t(toks[:, i:i + 1]), i)
        assert tc2 is tc
        _close(b, a, tol, f"decode {i}")
    _close(tc["mlstm"]["mC"], jc["mlstm"]["mC"], tol, "mC after decode")


def test_bf16_forward_matches_reference():
    """bf16 compute (params f32, heads and states f32) at two
    superblocks. The reference on the CPU keeps f32 between fused bf16
    ops (XLA's excess precision) where the port rounds each op to bf16,
    so the two differ by bf16 rounding noise: the port's logits must be
    no further from the reference's bf16 logits than those are from the
    reference's own f32 logits, in max and in mean (measured: 0.70 and
    0.85 of it); and the port's own bf16 run must differ from its f32 run
    (it does compute in bf16)."""
    jcfg, tcfg, jp, tp = _ref(4, "bfloat16")
    jf32, tf32, _, _ = _ref(4)
    toks = _tokens(4, 2, 64, jcfg.vocab_size)

    def j_fwd(cfg):
        return np.asarray(jax.jit(lambda p, x: JX.forward(
            p, x, cfg, remat=False))(jp, jnp.asarray(toks))[0])
    jl, jf = j_fwd(jcfg), j_fwd(jf32)
    tl, _ = TX.forward(tp, _t(toks), tcfg)
    assert tl.dtype == torch.float32
    noise, err = np.abs(jl - jf), np.abs(tl.numpy() - jl)
    assert err.max() <= noise.max() and err.mean() <= noise.mean(), \
        (err.max(), noise.max(), err.mean(), noise.mean())
    own = (tl - TX.forward(tp, _t(toks), tf32)[0]).abs().max().item()
    assert own > 0.25 * noise.max(), own


def test_decode_replay_matches_forward():
    """The reference's ``test_decode_consistency`` on the port: replaying
    12 tokens through ``decode_step`` gives the full forward's last-token
    logits at rtol/atol 5e-4, as there."""
    cfg = get_smoke_config(ARCH).replace(num_layers=4)
    model = get_model(cfg)
    params = model.init(7, device="cpu")
    toks = _t(_tokens(7, 2, 12, cfg.vocab_size))
    full, _ = TX.forward(params, toks, cfg)
    cache = model.init_cache(2, 12, device="cpu")
    for i in range(12):
        logits, cache = model.decode_step(params, cache, toks[:, i:i + 1], i)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=5e-4, atol=5e-4)


# ------------------------------------------------ the NaN departure

def test_reference_gradient_is_nan_at_two_chunks_port_is_finite():
    """At T = 512 the reference's ``where(tri, exp(seg), 0)`` overflows
    above the diagonal and its backward multiplies 0 by inf: its loss
    gradient has NaN. The port masks ``seg`` before the ``exp``: same
    loss (the forward's bits), every gradient finite."""
    jcfg, tcfg, jp, tp = _ref()
    toks = _tokens(5, 1, 513, jcfg.vocab_size)
    jloss, jg = _j_loss(jcfg)(jp, jnp.asarray(toks))
    n_nan = sum(int(np.isnan(np.asarray(g)).sum())
                for g in jax.tree.leaves(jg))
    assert np.isfinite(float(jloss)) and n_nan > 0
    tloss, tg = _t_loss_and_grads(tp, toks, tcfg)
    _close(tloss, jloss, MULTI, "loss")
    assert all(bool(torch.isfinite(g).all()) for g in tg.values())


def test_port_gradient_at_two_chunks_equals_its_recurrent_form(monkeypatch):
    """In float64, an mLSTM layer's chunked form at T = 512 (two chunks)
    and its step-by-step form (512 ``mlstm_decode`` calls) give the same
    outputs and parameter gradients, to rtol 1e-8 (atol 1e-10). The
    layer's rms_norm computes in f32 whatever its input, as the
    reference's does; here it runs in the input's dtype, so that both
    forms keep float64 end to end."""
    def rms_norm(x, w, eps=1e-5):
        return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True)
                               + eps) * w.to(x.dtype)
    monkeypatch.setattr(TL, "rms_norm", rms_norm)
    _, tcfg, _, tp = _ref()
    cfg = tcfg.replace(dtype="float64")
    lp = {k: v.double() for k, v in _layer(tp, "mlstm").items()}
    # forget gates near 1, so the state carries across the chunk boundary
    lp["gates.b"] = torch.cat([torch.zeros(4), torch.full((4,), 3.0)]).double()
    x = _t(_rand(11, 1, 512, cfg.d_model)).double()
    r = _t(_rand(12, 1, 512, cfg.d_model)).double()

    def grads(fn):
        leaves = {k: v.clone().requires_grad_() for k, v in lp.items()}
        out = fn(leaves)
        g = torch.autograd.grad((out * r).sum(), list(leaves.values()))
        return out.detach(), dict(zip(leaves, g))

    def recurrent(p):
        d_in, hd, _ = TX.dims(cfg)
        st = {"conv": torch.zeros((1, cfg.conv_width - 1, d_in),
                                  dtype=torch.float64),
              "mC": torch.zeros((1, 4, hd, hd), dtype=torch.float64),
              "mn": torch.zeros((1, 4, hd), dtype=torch.float64)}
        outs = []
        for s in range(512):
            y, st = TX.mlstm_decode(p, x[:, s:s + 1], st, cfg)
            outs.append(y)
        return torch.cat(outs, dim=1)

    out_c, g_c = grads(lambda p: TX.mlstm_forward(p, x, cfg)[0])
    out_r, g_r = grads(recurrent)
    np.testing.assert_allclose(out_c.numpy(), out_r.numpy(), rtol=1e-8,
                               atol=1e-10)
    for k in g_c:
        assert bool(torch.isfinite(g_c[k]).all()), k
        np.testing.assert_allclose(g_c[k].numpy(), g_r[k].numpy(), rtol=1e-8,
                                   atol=1e-10, err_msg=k)


# ------------------------------------------------------ train steps

def test_hetero_train_steps_match_reference():
    """Two tier-loop steps under AdamW(warmup_cosine(3e-4, 1, 2)), 4
    tiers, 8 x 32 tokens, at two superblocks: mean losses at rtol 1e-4, params after the two steps at atol 1e-5, each leaf
    moved by the updates."""
    jcfg, tcfg, jp, tp = _ref(4)
    jo = jopt.adamw(jopt.warmup_cosine(3e-4, 1, 2))
    to = topt.adamw(topt.warmup_cosine(3e-4, 1, 2))
    jstep = jax.jit(j_hetero_step(j_get_model(jcfg), jo,
                                  JC.default_tier_plans(4)))
    tstep = make_hetero_train_step(get_model(tcfg), to, default_tier_plans(4))
    js = dict(params=jp, opt=jo.init(jp), step=jnp.zeros((), jnp.int32))
    ts = dict(params=tp, opt=to.init(tp),
              step=torch.zeros((), dtype=torch.int32))
    for i in range(2):
        kw = dict(n_tiers=4, seed=3, index=i)
        b = make_train_batch(tcfg, ShapeConfig("t", 32, 8, "train"), **kw)
        jb = j_batch(jcfg, JShape("t", 32, 8, "train"), **kw)
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


@pytest.mark.parametrize("density", [0.25, 0.5, 0.9])
@pytest.mark.parametrize("leaf", ["zeros", "tiny", "half_zero"])
def test_magnitude_mask_of_zero_and_tiny_leaves_matches_reference(leaf,
                                                                  density):
    """The zero-initialized biases (``gates.b``, ``gates_x.b``,
    ``conv_b``) are compressible leaves. For a leaf whose largest |w| is
    below ~1e-26 the reference's lower bisection bound is a subnormal
    that its backend flushes to 0, so it keeps every weight; the port
    flushes it too. The masks are equal, and a zero leaf keeps all."""
    rng = np.random.default_rng(5)
    x = {"zeros": np.zeros((3, 7, 16)),
         "tiny": rng.standard_normal((3, 7, 16)) * 1e-33,
         "half_zero": np.concatenate([np.zeros((3, 4, 16)),
                                      rng.standard_normal((3, 3, 16)) * 1e-20],
                                     axis=1)}[leaf].astype(np.float32)
    ref = np.asarray(j_mask(jnp.asarray(x), density))
    out = magnitude_mask(_t(x), density).numpy()
    assert np.array_equal(out, ref)
    if leaf == "zeros":
        assert out.all()


def _state(seed: int):
    """A train state of the smoke config at two superblocks, with AdamW
    moments drawn from ``seed``, as numpy trees (the reference's)."""
    jcfg, _, jp, _ = _ref(4)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jp)
    return {"params": tree,
            "opt": {"m": jax.tree.map(lambda a: rng.standard_normal(
                        a.shape).astype(np.float32), tree),
                    "v": jax.tree.map(lambda a: rng.random(a.shape).astype(
                        np.float32), tree)},
            "step": np.int32(7)}


def _port_state(tree) -> dict:
    return {"params": params_from_numpy(tree["params"]),
            "opt": {s: params_from_numpy(tree["opt"][s]) for s in ("m", "v")},
            "step": torch.tensor(int(tree["step"]), dtype=torch.int32)}


def test_checkpoint_crosses_both_ways(tmp_path):
    """A train state (nested ``blocks.mlstm.*`` leaves, the 5-D
    ``r_gates``, both AdamW moments) saved by the reference's
    Checkpointer restores in the port's bit for bit, and the port's
    restores in the reference's."""
    ref_tree = _state(1)
    JCheckpointer(str(tmp_path / "ref")).save(
        jax.tree.map(jnp.asarray, ref_tree), 7)
    tmpl = _port_state(_state(2))
    got, step = Checkpointer(str(tmp_path / "ref")).restore(tmpl)
    want = _port_state(ref_tree)
    assert step == 7 and int(got["step"]) == 7
    for name in want["params"]:
        assert torch.equal(got["params"][name], want["params"][name]), name
        for s in ("m", "v"):
            assert torch.equal(got["opt"][s][name], want["opt"][s][name])
    Checkpointer(str(tmp_path / "port")).save(want, 9)
    back, step = JCheckpointer(str(tmp_path / "port")).restore(
        jax.tree.map(jnp.asarray, _state(3)))
    assert step == 9
    flat = params_from_numpy(jax.tree.map(np.asarray, back["params"]))
    assert all(torch.equal(flat[k], want["params"][k]) for k in flat)
    assert params_to_numpy(want["params"]).keys() == ref_tree["params"].keys()


def test_entry_points_run_on_cpu(capsys):
    """The serve and train launchers take the family: serve's tokens and
    logits finite; two train steps with finite losses."""
    res = serve_mod.main(["--arch", ARCH, "--smoke", "--tier", "low",
                          "--batch", "2", "--prompt-len", "8", "--gen", "4",
                          "--device", "cpu"])
    assert res["tokens"].shape == (2, 5)
    assert torch.isfinite(res["prefill_logits"]).all()
    res = train_mod.main(["--arch", ARCH, "--smoke", "--steps", "2",
                          "--batch", "4", "--seq", "16", "--device", "cpu",
                          "--log-every", "1"])
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert "done" in capsys.readouterr().out
