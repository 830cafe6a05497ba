"""Port parity for the Zamba hybrid family (``models/mamba2.py``,
``models/zamba.py``), on the CPU: the config and leaf table, the causal
conv, JAX's softplus and the init's linspaces, the chunked SSD scan, the
Mamba2 block (train form and decode form), the model's forward (chunked
and flash attention in the shared block), loss, gradients (the shared
block's summed over its applications), prefill cache and decode, a bf16
forward, two tier-loop AdamW steps with flash, and train-state
checkpoints that cross between the packages.

Tolerances. One chunk (T = 64): logits 1e-5, gradients rtol 1e-4.
Several chunks (T = 512): ``jnp.cumsum`` and ``torch.cumsum`` sum the
log decays in other orders, an ulp apart, and ``exp(cum)`` turns that
into |cum| ulps (|cum| up to ~40 here), so the multi-chunk checks use
rtol/atol 5e-5. The reference's params cross over through
``repro_torch.interop``; inputs come from numpy seeds."""
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
from repro.core.steps import make_hetero_train_step as j_hetero_step
from repro.data.synthetic import make_train_batch as j_batch
from repro.models import get_model as j_get_model
from repro.models import mamba2 as JM
from repro.models import zamba as JZ
from repro_torch import optim as topt
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ShapeConfig, get_config, get_smoke_config
from repro_torch.core.compression import compressible, default_tier_plans
from repro_torch.core.steps import make_hetero_train_step
from repro_torch.data.synthetic import make_train_batch
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM
from repro_torch.models import zamba as TZ

torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
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


def _close_scaled(a, b, tol, msg=""):
    """``_close`` with atol relative to b's largest magnitude (at least 1):
    for activations that grow through the layers."""
    scale = max(1.0, float(np.abs(_np(b)).max()))
    np.testing.assert_allclose(_np(a), _np(b), err_msg=msg, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _ref(layers: int = 2, dtype: str = "float32", use_flash: bool = False):
    """(reference cfg, port cfg, reference params, the same as the port's
    name -> tensor dict) for the smoke config at ``layers`` layers."""
    kw = dict(num_layers=layers, dtype=dtype, use_flash=use_flash)
    jcfg, tcfg = j_smoke(ARCH).replace(**kw), get_smoke_config(ARCH).replace(**kw)
    jp = JZ.init(jax.random.PRNGKey(layers), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _tokens(seed, b, t, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def _mamba(tp, jp, i: int = 0):
    """Layer i's mamba params: the port's view and the reference's."""
    return (TL.subtree({k: v[i] for k, v in TL.subtree(tp, "layers.").items()},
                       "mamba."),
            jax.tree.map(lambda a: a[i], jp["layers"]["mamba"]))


# ------------------------------------------------------------- config

def test_config_and_registry():
    """The smoke config (``ssm_headdim`` 32) and the full config are the
    reference's; ``get_model`` serves the family."""
    assert vars(get_smoke_config(ARCH)) == vars(j_smoke(ARCH))
    assert vars(get_config(ARCH)) == vars(j_config(ARCH))
    assert get_smoke_config(ARCH).ssm_headdim == 32
    model = get_model(get_smoke_config(ARCH))
    assert model.init.func is TZ.init and model.cfg.family == "hybrid"


def test_full_leaf_table_matches_reference():
    """chip_smoke.py's leaf table of the full config is ``jax.eval_shape``
    of the reference's init: 21 leaves, 18 compressible in both packages
    (the stacked ``a_log``, ``dt_bias``, ``d_skip`` (54, 80) among them),
    2,422,670,240 params."""
    cfg = j_config(ARCH)
    shapes = jax.eval_shape(lambda k: JZ.init(k, cfg), jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    ref = {".".join(str(getattr(k, "key", k)) for k in path): tuple(x.shape)
           for path, x in flat}
    smoke = runpy.run_path("chip_smoke.py", run_name="chip_smoke")
    table = smoke["_lm_leaf_shapes"](get_config(ARCH))
    assert list(table.items()) == list(ref.items())
    n_ref = sum(JC.compressible(p, x) for p, x in flat)
    mine = [k for k, s in table.items()
            if compressible(k, torch.empty(s, device="meta"))]
    assert len(table) == 21 and len(mine) == n_ref == 18
    assert smoke["_n_compressible"](get_config(ARCH)) == 18
    assert sum(int(np.prod(s)) for s in table.values()) == 2_422_670_240
    for k in ("a_log", "dt_bias", "d_skip"):
        assert f"layers.mamba.{k}" in mine and \
            table[f"layers.mamba.{k}"] == (54, 80)


@pytest.mark.parametrize("layers", [2, 4])
def test_param_leaves_match_reference(layers):
    """The port's init gives the reference's leaves (names in its flatten
    order, shapes), and ``a_log`` / ``dt_bias`` within an ulp of its
    linspaces (XLA's CPU code rounds an entry or two an ulp apart)."""
    jcfg, tcfg, jp, tp = _ref(layers)
    mine = TZ.init(0, tcfg, device="cpu")
    assert list(mine) == list(tp)
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in tp.items()}
    for k in ("a_log", "dt_bias", "d_skip", "gate_norm", "conv_b"):
        name = f"layers.mamba.{k}"
        assert _ulps(mine[name].numpy(), tp[name].numpy()).max() <= 1, name


def test_softplus_and_log_sigmoid_match_reference():
    """JAX's formula: within 2 ulps of XLA's where the value is a normal
    f32 (its exp and log1p are its own), gradient within 1e-6."""
    x = np.concatenate([_rand(0, 20000, scale=30.0),
                        np.array([0.0, -0.0, 20.5, 19.9, 60.0, -60.0],
                                 np.float32)])
    for jf, tf in ((jax.nn.softplus, TL.softplus),
                   (jax.nn.log_sigmoid, TL.log_sigmoid)):
        ref = np.asarray(jf(jnp.asarray(x)))
        xt = _t(x).requires_grad_()
        out = tf(xt)
        normal = np.abs(ref) >= 2.0 ** -126
        assert _ulps(out.detach().numpy(), ref)[normal].max() <= 2
        gref = np.asarray(jax.grad(lambda v: jf(v).sum())(jnp.asarray(x)))
        (g,) = torch.autograd.grad(out.sum(), xt)
        np.testing.assert_allclose(g.numpy(), gref, rtol=0, atol=1e-6)


# ------------------------------------------------------ per function

@pytest.mark.parametrize("t", [2, 64])
def test_causal_conv_matches_reference(t):
    """``causal_conv`` against ``mamba2._causal_conv`` (f32, 1e-5) over
    the conv width d_in + 2N, shorter than W - 1 included."""
    jcfg, _, jp, tp = _ref()
    tm, jm = _mamba(tp, jp)
    jm = {**jm, "conv_b": jnp.asarray(_rand(4, *jm["conv_b"].shape))}
    x = _rand(1, 2, t, tm["conv_w"].shape[0])
    ref = JM._causal_conv(jm, jnp.asarray(x), jcfg)
    _close(TL.causal_conv(_t(x), tm["conv_w"], _t(jm["conv_b"])), ref, TOL)


def _scan_inputs(seed, t, b=2, h=8, p=32, n=16):
    x = _rand(seed, b, t, h, p)
    bm, cm = _rand(seed + 1, b, t, n, scale=0.5), _rand(seed + 2, b, t, n,
                                                         scale=0.5)
    dt = np.log1p(np.exp(_rand(seed + 3, b, t, h, shift=-3.0)))
    a = -np.linspace(0.2, 2.0, h).astype(np.float32)
    return x, bm, cm, dt.astype(np.float32), a


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t", [64, 512])
def test_ssd_scan_matches_reference(t, with_state):
    """``_ssd_scan`` at one chunk (1e-5) and two (the multi-chunk
    tolerance), from zeros or a given state: y and the final state. The
    decays are small (dt ~ softplus(N(-3, 1))), so the state carries
    across the chunk boundary."""
    jcfg, tcfg, _, _ = _ref()
    xs = _scan_inputs(0, t)
    st = _rand(9, 2, 8, 32, 16, scale=0.3) if with_state else None
    jy, js = jax.jit(lambda *a: JM._ssd_scan(*a, jcfg, init_state=None
                                             if st is None else jnp.asarray(
                                                 st)))(*map(jnp.asarray, xs))
    ty, ts = TM._ssd_scan(*map(_t, xs), tcfg,
                          init_state=None if st is None else _t(st))
    tol = TOL if t <= TM.CHUNK else MULTI
    _close(ty, jy, tol, "y")
    _close(ts, js, tol, "state")


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t", [64, 512])
def test_mamba_forward_and_decode_match_reference(t, with_state):
    """``mamba_forward`` (output, conv tail, SSM state), from zeros or from
    a given SSM state, then 4 ``mamba_decode`` steps carried from its
    state."""
    jcfg, tcfg, jp, tp = _ref()
    tm, jm = _mamba(tp, jp)
    u = _rand(2, 2, t, jcfg.d_model)
    _, nh, _ = TM.dims(tcfg)
    st = ({"ssm": _rand(3, 2, nh, jcfg.ssm_headdim, jcfg.ssm_state,
                        scale=0.3)} if with_state else None)
    jy, js = JM.mamba_forward(jm, jnp.asarray(u), jcfg,
                              None if st is None else jax.tree.map(
                                  jnp.asarray, st))
    ty, ts = TM.mamba_forward(tm, _t(u), tcfg,
                              None if st is None else jax.tree.map(_t, st))
    tol = TOL if t <= TM.CHUNK else MULTI
    _close(ty, jy, tol, "out")
    assert set(ts) == set(js) == {"conv", "ssm"}
    for k in js:
        assert tuple(ts[k].shape) == js[k].shape
        _close(ts[k], js[k], tol, k)
    for i in range(4):
        ui = _rand(20 + i, 2, 1, jcfg.d_model)
        jy, js = JM.mamba_decode(jm, jnp.asarray(ui), js, jcfg)
        ty, ts = TM.mamba_decode(tm, _t(ui), ts, tcfg)
        _close(ty, jy, tol, f"decode {i}")
        for k in js:
            _close(ts[k], js[k], tol, f"decode {i} {k}")


# ------------------------------------------------------------ model

def _j_loss(cfg):
    return jax.jit(jax.value_and_grad(
        lambda p, toks: JZ.loss_fn(p, {"tokens": toks}, cfg)))


@pytest.mark.parametrize("layers,use_flash", [(2, False), (4, False),
                                              (4, True)])
def test_forward_loss_and_grads_match_reference(layers, use_flash):
    """One chunk (T = 64): logits and loss at rtol/atol 1e-5, every
    gradient at rtol 1e-4 (atol 1e-6), at one and two applications of
    the shared block (its gradient summed over both), with the chunked
    attention and with flash (its plain version on the CPU)."""
    jcfg, tcfg, jp, tp = _ref(layers, use_flash=use_flash)
    toks = _tokens(1, 2, 65, jcfg.vocab_size)
    jl, _ = jax.jit(lambda p, x: JZ.forward(p, x, jcfg, remat=False))(
        jp, jnp.asarray(toks[:, :-1]))
    tl, _ = TZ.forward(tp, _t(toks[:, :-1]), tcfg)
    _close(tl, jl, TOL, "logits")
    jloss, jg = _j_loss(jcfg)(jp, jnp.asarray(toks))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tloss = TZ.loss_fn(leaves, {"tokens": _t(toks)}, tcfg)
    tg = dict(zip(leaves, torch.autograd.grad(tloss, list(leaves.values()))))
    _close(tloss, jloss, TOL, "loss")
    for name, a in params_from_numpy(jax.tree.map(np.asarray, jg)).items():
        np.testing.assert_allclose(tg[name].numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_forward_multi_chunk_matches_reference():
    """T = 512 (two SSD chunks per layer) at two applications: logits
    at the multi-chunk tolerance."""
    jcfg, tcfg, jp, tp = _ref(4)
    toks = _tokens(2, 1, 512, jcfg.vocab_size)
    jl, _ = jax.jit(lambda p, x: JZ.forward(p, x, jcfg, remat=False))(
        jp, jnp.asarray(toks))
    tl, _ = TZ.forward(tp, _t(toks), tcfg)
    _close(tl, jl, MULTI)


@pytest.mark.parametrize("t", [64, 512])
def test_prefill_cache_and_decode_match_reference(t):
    """``prefill``'s last-token logits and every cache leaf (the names,
    shapes and dtypes of the reference's ``init_cache``; per-application
    KV caches with slot_pos = arange(T); values to the tolerance times
    the leaf's largest magnitude), then 8 ``decode_step``s carried
    through the prefill cache (a ring of T slots, which decode overwrites
    from slot 0 on, in both packages), at two applications."""
    jcfg, tcfg, jp, tp = _ref(4)
    model = get_model(tcfg)
    toks = _tokens(3, 2, t + 8, jcfg.vocab_size)
    jl, jc = jax.jit(lambda p, x: JZ.prefill(p, x, jcfg))(
        jp, jnp.asarray(toks[:, :t]))
    tl, tc = model.prefill(tp, {"tokens": _t(toks[:, :t])})
    tol = TOL if t <= TM.CHUNK else MULTI
    _close(tl, jl, tol, "prefill logits")
    empty = jax.tree.map(np.asarray, JZ.init_cache(jcfg, 2, t))
    mine = model.init_cache(2, t, device="cpu")
    for part in ("mamba", "attn"):
        assert set(tc[part]) == set(jc[part]) == set(empty[part]) == \
            set(mine[part])
        for k in jc[part]:
            assert tuple(tc[part][k].shape) == jc[part][k].shape == \
                empty[part][k].shape == tuple(mine[part][k].shape)
            assert str(mine[part][k].dtype).removeprefix("torch.") == \
                str(empty[part][k].dtype)
            assert torch.equal(mine[part][k], torch.zeros_like(mine[part][k]))
            _close_scaled(tc[part][k], jc[part][k], tol, f"{part}.{k}")
    j_decode = jax.jit(lambda p, c, x, i: JZ.decode_step(p, c, x, i, jcfg))
    for i in range(t, t + 8):
        a, jc = j_decode(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        b, tc2 = model.decode_step(tp, tc, _t(toks[:, i:i + 1]), i)
        assert tc2 is tc
        _close(b, a, tol, f"decode {i}")
    for part in ("mamba", "attn"):
        for k in jc[part]:
            _close_scaled(tc[part][k], jc[part][k], tol, f"{part}.{k} after")


@pytest.mark.parametrize("n_tokens,cache_len", [(10, 16), (12, 12)])
def test_decode_attends_to_empty_slots_as_reference(n_tokens, cache_len):
    """As in the reference, ``init_cache`` gives slot_pos 0, so a decode
    step also attends to the slots not written yet (k = v = 0), at two
    applications: the port's logits equal the reference's at every step
    (1e-5), and both differ from the full forward's last-token logits,
    whether the cache outlasts the tokens (16 for 10) or the replay fills
    it (12 for 12: the first application's steps before then saw empty
    slots, and layers 3-4 carry that in their states)."""
    jcfg, tcfg, jp, tp = _ref(4)
    model = get_model(tcfg)
    toks = _tokens(6, 2, n_tokens, jcfg.vocab_size)
    jc = JZ.init_cache(jcfg, 2, cache_len)
    tc = model.init_cache(2, cache_len, device="cpu")
    j_decode = jax.jit(lambda p, c, x, i: JZ.decode_step(p, c, x, i, jcfg))
    for i in range(n_tokens):
        a, jc = j_decode(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        b, tc = model.decode_step(tp, tc, _t(toks[:, i:i + 1]), i)
        _close(b, a, TOL, f"decode {i}")
    full, _ = TZ.forward(tp, _t(toks), tcfg)
    assert (b[:, 0] - full[:, -1]).abs().max().item() > 1e-2


def test_decode_replay_matches_forward():
    """The reference's ``test_decode_consistency`` on the port, at the
    smoke config as there (one application, after the last layer):
    replaying 12 tokens through ``decode_step`` into a cache of 12 gives
    the full forward's last-token logits at rtol/atol 5e-4."""
    cfg = get_smoke_config(ARCH)
    model = get_model(cfg)
    params = model.init(7, device="cpu")
    toks = _t(_tokens(7, 2, 12, cfg.vocab_size))
    full, _ = TZ.forward(params, toks, cfg)
    cache = model.init_cache(2, 12, device="cpu")
    for i in range(12):
        logits, cache = model.decode_step(params, cache, toks[:, i:i + 1], i)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=5e-4, atol=5e-4)


def test_bf16_forward_matches_reference():
    """bf16 compute at two applications. The reference on the CPU keeps
    f32 between fused bf16 ops where the port rounds each op to bf16, so
    the port's logits must be no further from the reference's bf16
    logits than those are from the reference's own f32 logits, in max
    and in mean; and the port's bf16 run must differ from its f32 run."""
    jcfg, tcfg, jp, tp = _ref(4, "bfloat16")
    jf32, tf32, _, _ = _ref(4)
    toks = _tokens(4, 2, 64, jcfg.vocab_size)

    def j_fwd(cfg):
        return np.asarray(jax.jit(lambda p, x: JZ.forward(
            p, x, cfg, remat=False))(jp, jnp.asarray(toks))[0])
    jl, jf = j_fwd(jcfg), j_fwd(jf32)
    tl, _ = TZ.forward(tp, _t(toks), tcfg)
    assert tl.dtype == torch.float32
    noise, err = np.abs(jl - jf), np.abs(tl.numpy() - jl)
    assert err.max() <= noise.max() and err.mean() <= noise.mean(), \
        (err.max(), noise.max(), err.mean(), noise.mean())
    own = (tl - TZ.forward(tp, _t(toks), tf32)[0]).abs().max().item()
    assert own > 0.25 * noise.max(), own


# ------------------------------------------------------ train steps

def test_hetero_train_steps_match_reference():
    """Two tier-loop steps under AdamW(warmup_cosine(3e-4, 1, 2)) with
    flash attention in the shared block, 4 tiers, 8 x 32 tokens, at two
    applications: mean losses at rtol 1e-4, params after the two steps at
    atol 1e-5, each leaf moved by the updates (the compressed stacked
    ``a_log`` / ``dt_bias`` / ``d_skip`` too)."""
    jcfg, tcfg, jp, tp = _ref(4, use_flash=True)
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
    jflat = params_from_numpy(jax.tree.map(np.asarray, js["params"]))
    for name, a in jflat.items():
        np.testing.assert_allclose(ts["params"][name].numpy(), a.numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
        assert not torch.equal(ts["params"][name], tp[name]), name


def test_checkpoint_crosses_both_ways(tmp_path):
    """The train state (params and AdamW moments under ``shared.*`` and
    the stacked ``layers.mamba.*``) saved by the reference's Checkpointer
    restores in the port's bit for bit, and the port's in the
    reference's."""
    _, _, jp, _ = _ref(4)
    rng = np.random.default_rng(1)
    tree = jax.tree.map(np.asarray, jp)
    ref = {"params": tree,
           "opt": {"m": jax.tree.map(lambda a: rng.standard_normal(
                       a.shape).astype(np.float32), tree),
                   "v": jax.tree.map(lambda a: rng.random(a.shape).astype(
                       np.float32), tree)},
           "step": np.int32(5)}
    JCheckpointer(str(tmp_path / "ref")).save(jax.tree.map(jnp.asarray, ref), 5)

    def port(t):
        return {"params": params_from_numpy(t["params"]),
                "opt": {s: params_from_numpy(t["opt"][s]) for s in ("m", "v")},
                "step": torch.tensor(int(t["step"]), dtype=torch.int32)}
    want = port(ref)
    zeros = jax.tree.map(np.zeros_like, ref)
    got, step = Checkpointer(str(tmp_path / "ref")).restore(port(zeros))
    assert step == 5 and int(got["step"]) == 5
    for name in want["params"]:
        assert torch.equal(got["params"][name], want["params"][name]), name
        for s in ("m", "v"):
            assert torch.equal(got["opt"][s][name], want["opt"][s][name])
    Checkpointer(str(tmp_path / "port")).save(want, 6)
    back, step = JCheckpointer(str(tmp_path / "port")).restore(
        jax.tree.map(jnp.asarray, zeros))
    assert step == 6
    for part in (back["params"], back["opt"]["m"], back["opt"]["v"]):
        flat = params_from_numpy(jax.tree.map(np.asarray, part))
        src = (want["params"] if part is back["params"] else
               want["opt"]["m" if part is back["opt"]["m"] else "v"])
        assert all(torch.equal(flat[k], src[k]) for k in flat)


def test_entry_points_run_on_cpu(capsys):
    """The serve and train launchers take the family (train with
    ``--use-flash``): tokens and logits finite, two finite losses."""
    res = serve_mod.main(["--arch", ARCH, "--smoke", "--tier", "low",
                          "--batch", "2", "--prompt-len", "8", "--gen", "4",
                          "--device", "cpu"])
    assert res["tokens"].shape == (2, 5)
    assert torch.isfinite(res["prefill_logits"]).all()
    res = train_mod.main(["--arch", ARCH, "--smoke", "--steps", "2",
                          "--batch", "4", "--seq", "16", "--device", "cpu",
                          "--use-flash", "--log-every", "1"])
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert "done" in capsys.readouterr().out
