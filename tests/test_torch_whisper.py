"""Port parity for the Whisper encoder-decoder (``models/whisper.py`` and
the cross-attention, GELU and non-RoPE parts of ``models/layers.py``), on
the CPU: the config and leaf table, ``attn_forward``'s cross / non-causal
/ no-RoPE options, ``cross_attn_decode``, ``gelu_mlp``, the sinusoid
positions, the encoder, the teacher-forced decoder, loss and gradients
(chunked and flash attention), prefill caches and decode, the serve
launcher's decode with zero cross-KV, audio batches, compression for
serving, a bf16 forward, two tier-loop AdamW steps and train-state
checkpoints that cross between the packages.

Tolerances: activations and logits 1e-5, gradients rtol 1e-4. The
reference's params cross over through ``repro_torch.interop``; inputs
come from numpy seeds. The sinusoid table at 1500 positions is held
through its frequencies (one ulp: XLA's and torch's f32 ``exp``) and,
given the reference's frequencies, to 1e-7."""
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
from repro.core.compression.pruning import _threshold as j_threshold
from repro.core.steps import make_hetero_train_step as j_hetero_step
from repro.data.synthetic import make_train_batch as j_batch
from repro.models import get_model as j_get_model
from repro.models import layers as JL
from repro.models import whisper as JW
from repro_torch import optim as topt
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ShapeConfig, get_config, get_smoke_config
from repro_torch.core.compression import (DEVICE_TIERS, compress_params,
                                          compressible, default_tier_plans)
from repro_torch.core import steps as steps_mod
from repro_torch.core.steps import compress_for_serving, make_hetero_train_step
from repro_torch.data.synthetic import TokenStream, make_train_batch
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.models import whisper as TW

torch.set_num_threads(1)

ARCH = "whisper-tiny"
TOL = dict(rtol=1e-5, atol=1e-5)
B, T = 2, 12


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _close(a, b, tol=TOL, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), err_msg=msg, **tol)


def _ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _ref(dtype: str = "float32", use_flash: bool = False):
    """(reference cfg, port cfg, reference params, the same as the port's
    name -> tensor dict) at the smoke config."""
    kw = dict(dtype=dtype, use_flash=use_flash)
    jcfg = j_smoke(ARCH).replace(**kw)
    tcfg = get_smoke_config(ARCH).replace(**kw)
    jp = JW.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _inputs(seed, cfg, t=T):
    """(frames (B, encoder_seq, D) f32, tokens (B, t) int32)."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, t))
    return (_rand(seed + 100, B, cfg.encoder_seq, cfg.d_model),
            toks.astype(np.int32))


def _layer(tp, jp, stack="dec_layers", i=0):
    """Layer i of a stack: the port's nested view and the reference's."""
    return (TW._layers(tp, stack + ".")[i],
            jax.tree.map(lambda a: a[i], jp[stack]))


# ------------------------------------------------------------- config

def test_config_and_registry():
    """The smoke and full configs are the reference's; ``get_model``
    serves the audio family, its prefill taking the whole batch."""
    assert vars(get_smoke_config(ARCH)) == vars(j_smoke(ARCH))
    assert vars(get_config(ARCH)) == vars(j_config(ARCH))
    model = get_model(get_smoke_config(ARCH))
    assert model.init.func is TW.init and model.cfg.family == "audio"
    _, tcfg, _, tp = _ref()
    frames, toks = _inputs(0, tcfg)
    a, _ = model.prefill(tp, {"frames": _t(frames), "tokens": _t(toks)})
    b, _ = TW.prefill(tp, {"frames": _t(frames), "tokens": _t(toks)}, tcfg)
    assert torch.equal(a, b)


def test_full_leaf_table_matches_reference():
    """chip_smoke.py's leaf table of the full config is ``jax.eval_shape``
    of the reference's init: 35 leaves, 31 compressible in both packages
    (the stacked norms and the zero-initialized MLP biases among them),
    36,463,488 params; the port's init has those leaves."""
    cfg = j_config(ARCH)
    shapes = jax.eval_shape(lambda k: JW.init(k, cfg), jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    ref = {".".join(str(getattr(k, "key", k)) for k in path): tuple(x.shape)
           for path, x in flat}
    smoke = runpy.run_path("chip_smoke.py", run_name="chip_smoke")
    table = smoke["_lm_leaf_shapes"](get_config(ARCH))
    assert list(table.items()) == list(ref.items())
    n_ref = sum(JC.compressible(p, x) for p, x in flat)
    mine = [k for k, s in table.items()
            if compressible(k, torch.empty(s, device="meta"))]
    assert len(table) == 35 and len(mine) == n_ref == 31
    assert smoke["_n_compressible"](get_config(ARCH)) == 31
    assert sum(int(np.prod(s)) for s in table.values()) == 36_463_488
    for k in ("dec_layers.mlp.wi.b", "enc_layers.ln1.b", "dec_layers.ln_x.w"):
        assert k in mine


def test_param_leaves_match_reference():
    """The port's init gives the reference's leaves (names in its flatten
    order, shapes); norms are ones and zeros, biases zeros."""
    _, tcfg, _, tp = _ref()
    mine = TW.init(0, tcfg, device="cpu")
    assert list(mine) == list(tp)
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in tp.items()}
    for k, v in mine.items():
        if k.endswith(".b"):
            assert torch.equal(v, torch.zeros_like(v)), k
        elif "." in k and (k.split(".")[-2].startswith("ln")
                           or k.endswith("norm.w")):
            assert torch.equal(v, torch.ones_like(v)), k


# ---------------------------------------------------------- layers

ATTN_CASES = {
    # (kv_src, use_rope, causal, positions)
    "self_causal_rope": (False, True, True, None),
    "self_rope_positions": (False, True, True, 5),
    "self_noncausal_no_rope": (False, False, False, None),
    "cross_no_rope": (True, False, False, None),
    "cross_causal_ignored": (True, False, True, None),
    "cross_rope": (True, True, False, 3),
}


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attn_forward_matches_reference(case, use_flash):
    """``attn_forward`` with ``kv_src`` (T = 12 queries over the 16 encoder
    frames: causal is dropped for cross-attention), ``causal=False``,
    ``use_rope=False`` and shifted ``positions``, through the chunked
    attention and flash (its plain version on the CPU): 1e-5."""
    jcfg, tcfg, jp, tp = _ref(use_flash=use_flash)
    tl, jl = _layer(tp, jp)
    cross, rope, causal, shift = ATTN_CASES[case]
    x = _rand(1, B, T, jcfg.d_model)
    src = _rand(2, B, jcfg.encoder_seq, jcfg.d_model) if cross else None
    pos = None if shift is None else np.arange(T) + shift
    ref = JL.attn_forward(jl["xattn" if cross else "attn"], jnp.asarray(x),
                          jcfg, use_rope=rope, causal=causal,
                          kv_src=None if src is None else jnp.asarray(src),
                          positions=None if pos is None else jnp.asarray(pos))
    out = TL.attn_forward(tl["xattn" if cross else "attn"], _t(x), tcfg,
                          use_rope=rope, causal=causal,
                          kv_src=None if src is None else _t(src),
                          positions=None if pos is None else _t(pos))
    _close(out, ref)


def test_cross_attn_decode_matches_reference():
    """``cross_attn_decode`` against precomputed encoder K/V with GQA (the
    smoke config's 4 query heads over 2 KV heads): 1e-5; with zero K/V
    its output is exactly 0 in both packages."""
    jcfg, tcfg, jp, tp = _ref()
    tl, jl = _layer(tp, jp)
    x = _rand(3, B, 1, jcfg.d_model)
    kv = [_rand(4 + i, B, jcfg.encoder_seq, jcfg.num_kv_heads, jcfg.head_dim)
          for i in range(2)]
    ref = JL.cross_attn_decode(jl["xattn"], jnp.asarray(x),
                               tuple(map(jnp.asarray, kv)), jcfg)
    _close(TL.cross_attn_decode(tl["xattn"], _t(x), tuple(map(_t, kv)),
                                tcfg), ref)
    zero = np.zeros_like(kv[0])
    assert not np.asarray(JL.cross_attn_decode(
        jl["xattn"], jnp.asarray(x), (jnp.asarray(zero),) * 2, jcfg)).any()
    assert not TL.cross_attn_decode(tl["xattn"], _t(x), (_t(zero),) * 2,
                                    tcfg).any()


def test_gelu_mlp_matches_reference():
    """``gelu_mlp`` (biased wi / wo, tanh GELU, as ``jax.nn.gelu``'s
    default) with nonzero biases: 1e-5; the erf GELU would miss it."""
    jcfg, _, jp, tp = _ref()
    tl, jl = _layer(tp, jp)
    rng = np.random.default_rng(6)
    jm = {k: {**v, "b": jnp.asarray(rng.standard_normal(v["b"].shape)
                                    .astype(np.float32))}
          for k, v in jl["mlp"].items()}
    tm = {f"{k}.{leaf}": _t(v[leaf]) for k, v in jm.items() for leaf in v}
    x = _rand(7, B, T, jcfg.d_model, scale=3.0)
    ref = np.asarray(JL.gelu_mlp(jm, jnp.asarray(x)))
    _close(TL.gelu_mlp(tm, _t(x)), ref)
    erf = TL.proj(tm, "wo", torch.nn.functional.gelu(TL.proj(tm, "wi",
                                                             _t(x))))
    assert np.abs(erf.numpy() - ref).max() > 1e-4


# -------------------------------------------------------- sinusoid

def test_sinusoid_matches_reference():
    """The sinusoid table at the smoke config's 16 frame positions, at its
    width and at whisper-tiny's: 1e-5."""
    pos = np.arange(16)
    for d in (128, 384):
        ref = JW.sinusoid(jnp.asarray(pos), d, jnp.float32)
        _close(TW.sinusoid(_t(pos), d, torch.float32), ref)


def test_sinusoid_frequencies_within_one_ulp_of_reference():
    """At whisper-tiny's width the two packages' f32 frequencies differ by
    at most one ulp (XLA's and torch's ``exp``); the angle pos * freq
    carries that ulp up to ~pos times, so at 1500 frame positions the
    tables differ by no more than pos * ulp(freq) (1.22e-4 measured)."""
    d = 384
    half = d // 2
    jfreq = np.asarray(jnp.exp(-np.log(10_000.0) * jnp.arange(
        half, dtype=jnp.float32) / half))
    tfreq = TW.sinusoid_freq(d).numpy()
    assert _ulps(tfreq, jfreq).max() <= 1
    pos = np.arange(1500)
    ref = np.asarray(JW.sinusoid(jnp.asarray(pos), d, jnp.float32))
    out = TW.sinusoid(_t(pos), d, torch.float32).numpy()
    # the angles differ by pos * |freq - freq'| plus each one's rounding
    ang = pos[:, None] * jfreq[None, :]
    bound = (pos[:, None] * np.abs(tfreq - jfreq)[None, :]
             + np.spacing(ang.astype(np.float32)) + 1e-6)
    assert (np.abs(out - ref) <= np.concatenate([bound, bound], 1)).all()


def test_sinusoid_given_reference_frequencies_within_1e7(monkeypatch):
    """Given the reference's frequencies, the port's table at 1500
    positions is the reference's to 1e-7: torch's sin / cos of the same
    f32 angles."""
    d = 384
    half = d // 2
    jfreq = np.asarray(jnp.exp(-np.log(10_000.0) * jnp.arange(
        half, dtype=jnp.float32) / half))
    monkeypatch.setattr(TW, "sinusoid_freq", lambda d_model, device=None:
                        _t(jfreq).to(device))
    pos = np.arange(1500)
    ref = np.asarray(JW.sinusoid(jnp.asarray(pos), d, jnp.float32))
    out = TW.sinusoid(_t(pos), d, torch.float32).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-7)


# ------------------------------------------------------------ model

def _j_loss(cfg):
    return jax.jit(jax.value_and_grad(lambda p, b: JW.loss_fn(p, b, cfg)))


@pytest.mark.parametrize("use_flash", [False, True])
def test_encode_decode_loss_and_grads_match_reference(use_flash):
    """``encode``, ``decode_train``'s logits and ``loss_fn`` at 1e-5, every
    gradient at rtol 1e-4 (atol 1e-6), with the chunked attention and
    with flash (its plain version on the CPU)."""
    jcfg, tcfg, jp, tp = _ref(use_flash=use_flash)
    frames, toks = _inputs(1, tcfg, T + 1)
    jenc = jax.jit(lambda p, f: JW.encode(p, f, jcfg))(jp, jnp.asarray(frames))
    tenc = TW.encode(tp, _t(frames), tcfg)
    _close(tenc, jenc, msg="encode")
    jl = jax.jit(lambda p, e, x: JW.decode_train(p, e, x, jcfg, remat=False))(
        jp, jenc, jnp.asarray(toks[:, :-1]))
    _close(TW.decode_train(tp, tenc, _t(toks[:, :-1]), tcfg), jl,
           msg="logits")
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}
    jloss, jg = _j_loss(jcfg)(jp, jb)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tloss = TW.loss_fn(leaves, {"frames": _t(frames), "tokens": _t(toks)},
                       tcfg)
    tg = dict(zip(leaves, torch.autograd.grad(tloss, list(leaves.values()))))
    _close(tloss, jloss, msg="loss")
    for name, a in params_from_numpy(jax.tree.map(np.asarray, jg)).items():
        np.testing.assert_allclose(tg[name].numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_cache_and_decode_match_reference(use_flash):
    """``prefill``'s last-token logits and every cache leaf (the names,
    shapes and dtypes of the reference's ``init_cache``: slot_pos =
    arange(T), the cross-KV of the 16 frames) at 1e-5; then a fresh cache
    of T + 8 slots seeded with prefill's cross-KV, as the reference's
    ``test_decode_consistency`` does, replays the T prompt tokens and 8
    more: every step's logits at 1e-5, the replay's last prompt step
    equal to prefill's logits (2e-4, the reference test's bar), the
    caches after."""
    jcfg, tcfg, jp, tp = _ref(use_flash=use_flash)
    model = get_model(tcfg)
    frames, toks = _inputs(2, tcfg, T + 8)
    jl, jc = jax.jit(lambda p, b: JW.prefill(p, b, jcfg))(
        jp, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks[:, :T])})
    tl, tc = model.prefill(tp, {"frames": _t(frames), "tokens":
                                _t(toks[:, :T])})
    _close(tl, jl, msg="prefill logits")
    empty = jax.tree.map(np.asarray, JW.init_cache(jcfg, B, T))["layers"]
    mine = model.init_cache(B, T, device="cpu")["layers"]
    assert set(tc["layers"]) == set(jc["layers"]) == set(empty) == set(mine)
    for k, v in jc["layers"].items():
        assert tuple(tc["layers"][k].shape) == v.shape == empty[k].shape \
            == tuple(mine[k].shape), k
        assert str(mine[k].dtype).removeprefix("torch.") == \
            str(empty[k].dtype), k
        assert np.array_equal(mine[k].numpy(), empty[k]), k
        _close(tc["layers"][k], v, msg=k)

    jcache = JW.init_cache(jcfg, B, T + 8)
    jcache["layers"]["enc_k"] = jc["layers"]["enc_k"]
    jcache["layers"]["enc_v"] = jc["layers"]["enc_v"]
    tcache = model.init_cache(B, T + 8, device="cpu")
    tcache["layers"]["enc_k"].copy_(tc["layers"]["enc_k"])
    tcache["layers"]["enc_v"].copy_(tc["layers"]["enc_v"])
    j_decode = jax.jit(lambda p, c, x, i: JW.decode_step(p, c, x, i, jcfg))
    for i in range(T + 8):
        a, jcache = j_decode(jp, jcache, jnp.asarray(toks[:, i:i + 1]),
                             jnp.int32(i))
        b, tc2 = model.decode_step(tp, tcache, _t(toks[:, i:i + 1]), i)
        assert tc2 is tcache
        _close(b, a, msg=f"decode {i}")
        if i == T - 1:
            np.testing.assert_allclose(b.numpy(), tl.numpy(), rtol=2e-4,
                                       atol=2e-4)
    for k, v in jcache["layers"].items():
        _close(tcache["layers"][k], v, msg=f"{k} after")


def test_decode_replay_matches_teacher_forcing():
    """The reference's ``test_whisper_decode_matches_teacher_forcing`` on
    the port: a cache seeded with the prefill's cross-KV (of a one-token
    prefill) replayed over 12 tokens gives ``decode_train``'s last-token
    logits at rtol/atol 2e-4."""
    cfg = get_smoke_config(ARCH)
    model = get_model(cfg)
    params = model.init(7, device="cpu")
    frames, toks = map(_t, _inputs(7, cfg))
    full = TW.decode_train(params, TW.encode(params, frames, cfg), toks, cfg)
    _, pcache = model.prefill(params, {"frames": frames,
                                       "tokens": toks[:, :1]})
    cache = model.init_cache(B, T, device="cpu")
    cache["layers"]["enc_k"] = pcache["layers"]["enc_k"]
    cache["layers"]["enc_v"] = pcache["layers"]["enc_v"]
    for i in range(T):
        logits, cache = model.decode_step(params, cache, toks[:, i:i + 1], i)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-4, atol=2e-4)


def test_launcher_decode_with_zero_cross_kv_matches_reference():
    """The serve launchers replay the prompt into a fresh ``init_cache``,
    whose cross-KV is zeros (reference ``launch/serve.py``), so decode
    does not see the audio. The port's sequence (the prompt replayed,
    then 8 greedy tokens) gives the reference's logits at every step
    (1e-5) and its tokens; the port's launcher returns that replay's last
    logits, which differ from prefill's."""
    jcfg, tcfg, jp, tp = _ref()
    model = get_model(tcfg)
    _, toks = _inputs(3, tcfg)
    jcache = JW.init_cache(jcfg, B, T + 8)
    tcache = model.init_cache(B, T + 8, device="cpu")
    j_decode = jax.jit(lambda p, c, x, i: JW.decode_step(p, c, x, i, jcfg))
    jt, tt = jnp.asarray(toks[:, :1]), _t(toks[:, :1])
    for i in range(T + 8):
        if i < T:
            jt, tt = jnp.asarray(toks[:, i:i + 1]), _t(toks[:, i:i + 1])
        a, jcache = j_decode(jp, jcache, jt, jnp.int32(i))
        b, tcache = model.decode_step(tp, tcache, tt, i)
        _close(b, a, msg=f"step {i}")
        jt = jnp.argmax(a[:, -1], -1).astype(jnp.int32)[:, None]
        tt = torch.argmax(b[:, -1], -1).to(torch.int32)[:, None]
        assert np.array_equal(tt.numpy(), np.asarray(jt)), i
    res = serve_mod.serve(tcfg, "hub", batch=B, prompt_len=T, gen=1,
                          seed=3, params=tp, device="cpu")
    prompt = TokenStream(tcfg.vocab_size, B, T, seed=3).batch_at(0)["tokens"]
    cache = model.init_cache(B, T + 1, device="cpu")
    for i in range(T):
        own, cache = model.decode_step(tp, cache, prompt[:, i:i + 1], i)
    assert torch.equal(res["replay_logits"], own)
    assert (res["replay_logits"] - res["prefill_logits"]).abs().max() > 1e-2


# ------------------------------------------------ batches and leaves

@pytest.mark.parametrize("n_tiers", [0, 4])
@pytest.mark.parametrize("full", [False, True])
def test_make_train_batch_audio_matches_reference(full, n_tiers):
    """Audio batches: the frames (drawn first, as float64 normals cast to
    the config's dtype: f32 at the smoke config, bf16 at the full one)
    and the T + 1 tokens are bitwise the reference's, with and without
    the tier axis."""
    cfg = (get_config if full else get_smoke_config)(ARCH)
    jcfg = (j_config if full else j_smoke)(ARCH)
    kw = dict(n_tiers=n_tiers, seed=4, index=2)
    b = make_train_batch(cfg, ShapeConfig("t", 24, 8, "train"), **kw)
    jb = j_batch(jcfg, JShape("t", 24, 8, "train"), **kw)
    assert set(b) == set(jb) == {"frames", "tokens"}
    lead = (4, 2) if n_tiers else (8,)
    assert tuple(b["frames"].shape) == (*lead, cfg.encoder_seq, cfg.d_model)
    assert tuple(b["tokens"].shape) == (*lead, 25)
    assert b["frames"].dtype == getattr(torch, cfg.dtype)
    assert np.array_equal(b["tokens"].numpy(), np.asarray(jb["tokens"]))
    f = b["frames"].to(torch.float32).numpy()
    assert np.array_equal(f, np.asarray(jb["frames"]).astype(np.float32))


@pytest.mark.parametrize("tier", list(DEVICE_TIERS))
def test_compress_for_serving_matches_reference(tier):
    """The 31 compressible leaves compress as in the reference: masks
    equal but for a weight within 4 ulps of the reference threshold
    (XLA's and torch's exp differ by an ulp), values bitwise where the
    masks agree (the clustered tier to atol 1e-6: its Lloyd update sums
    in another order); the zero MLP biases keep all their weights; the 4
    final norm leaves pass through."""
    jcfg, _, jp, tp = _ref()
    plan_j = JC.DEVICE_TIERS[tier]
    jc, jm = jax.jit(JC.compress_params, static_argnums=1)(jp, plan_j)
    tc = compress_for_serving(tp, DEVICE_TIERS[tier])
    _, tm = compress_params(tp, DEVICE_TIERS[tier])
    assert sum(compressible(k, v) for k, v in tp.items()) == 31
    leaves = [np.asarray(x) for x in jax.tree.leaves(jc)]
    masks = [np.asarray(x) for x in jax.tree.leaves(jm)]
    assert len(leaves) == len(tc) == 35
    for a, b, ma, mb, (name, w) in zip(leaves, tc.values(), masks,
                                       tm.values(), tp.items()):
        b, mb = b.numpy(), mb.numpy()
        flip = np.broadcast_to(ma != mb, a.shape)
        if flip.any():
            thr = np.float32(j_threshold(jnp.abs(jnp.asarray(w.numpy())),
                                         plan_j.density))
            aw = np.abs(w.numpy())[flip]
            assert (np.abs(aw - thr) <= 4 * np.spacing(thr)).all(), name
        if plan_j.cluster_k:
            np.testing.assert_allclose(b[~flip], a[~flip], rtol=0, atol=1e-6,
                                       err_msg=name)
        else:
            assert np.array_equal(b[~flip], a[~flip]), name
        if name.endswith("mlp.wi.b"):
            assert np.broadcast_to(mb, a.shape).all(), name


def test_bf16_forward_matches_reference():
    """bf16 compute (encoder and decoder). The reference on the CPU keeps
    f32 between fused bf16 ops (XLA's excess precision) where the port
    rounds each op to bf16, and here, unlike in the recurrent families,
    the port's logits land a little further from the reference's bf16
    logits than those are from the reference's own f32 logits (max
    0.0070 against 0.0058, mean 0.00133 against 0.00123): two bf16
    computations whose rounding errors are independent, each of the
    reference's own size, lie up to sqrt(2) times that size apart. So:
    the port's bf16 logits are within sqrt(2) x the reference's
    bf16-vs-f32 distance of both the reference's bf16 and its f32 logits,
    in max and in mean; and the port's bf16 run differs from its f32
    run (it does round to bf16)."""
    jcfg, tcfg, jp, tp = _ref("bfloat16")
    jf32, tf32, _, _ = _ref()
    frames, toks = _inputs(5, tcfg)

    def j_fwd(cfg):
        return np.asarray(jax.jit(lambda p, f, x: JW.decode_train(
            p, JW.encode(p, f, cfg), x, cfg, remat=False))(
                jp, jnp.asarray(frames), jnp.asarray(toks)))

    def t_fwd(cfg):
        return TW.decode_train(tp, TW.encode(tp, _t(frames), cfg), _t(toks),
                               cfg)
    jl, jf = j_fwd(jcfg), j_fwd(jf32)
    tl = t_fwd(tcfg)
    assert tl.dtype == torch.float32
    noise = np.abs(jl - jf)
    for truth in (jl, jf):
        err = np.abs(tl.numpy() - truth)
        assert err.max() <= np.sqrt(2) * noise.max() and \
            err.mean() <= np.sqrt(2) * noise.mean(), \
            (err.max(), noise.max(), err.mean(), noise.mean())
    own = (tl - t_fwd(tf32)).abs().max().item()
    assert own > 0.25 * noise.max(), own


# ------------------------------------------------------ train steps

def test_hetero_train_steps_match_reference():
    """Two tier-loop steps under AdamW(warmup_cosine(3e-4, 1, 2)) with
    flash attention, 4 tiers, 8 x 24 tokens over 16 frames each: mean
    losses at rtol 1e-4, params after the two steps at atol 1e-5, each
    leaf moved by the updates (the compressed stacked norms and zero
    biases too)."""
    jcfg, tcfg, jp, tp = _ref(use_flash=True)
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
        b = make_train_batch(tcfg, ShapeConfig("t", 24, 8, "train"), **kw)
        jb = j_batch(jcfg, JShape("t", 24, 8, "train"), **kw)
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, b)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4)
    jflat = params_from_numpy(jax.tree.map(np.asarray, js["params"]))
    for name, a in jflat.items():
        np.testing.assert_allclose(ts["params"][name].numpy(), a.numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
        assert not torch.equal(ts["params"][name], tp[name]), name


def test_second_sgd_step_flips_a_pruned_norm_scale_under_an_ulp(
        monkeypatch):
    """Why chip_smoke.py holds whisper's card-vs-CPU smoke params after
    the first step: the low tier prunes the stacked LayerNorm scales
    (compressible leaves, as in the reference), which one SGD(0.5) step
    leaves clustered just below 1.0, so moving every param of that state
    by one ulp flips one ``dec_layers.ln2.w`` entry of the low tier's
    step-2 mask between pruned and kept, and the params after step 2
    move by more than 1e-4 (1.2e-3 here, as much as the card's second
    step differs from the CPU's)."""
    cfg = get_smoke_config(ARCH).replace(use_flash=True)
    model = get_model(cfg)
    init = model.init(torch.Generator().manual_seed(0), device="cpu")
    orig = steps_mod.compress_with_masks

    def run(perturb: bool):
        masks = []

        def record(*a, **kw):
            cp, m = orig(*a, **kw)
            masks.append({k: v.clone() for k, v in m.items()})
            return cp, m
        monkeypatch.setattr(steps_mod, "compress_with_masks", record)
        opt = topt.sgd(0.5)
        step = make_hetero_train_step(model, opt, default_tier_plans(4))
        st = dict(params={k: v.clone() for k, v in init.items()}, opt=(),
                  step=torch.zeros((), dtype=torch.int32))
        for i in range(2):
            b = make_train_batch(cfg, ShapeConfig("t", 64, 8, "train"),
                                 n_tiers=4, seed=1, index=i)
            st, _ = step(st, b)
            if i == 0 and perturb:
                g = torch.Generator().manual_seed(3)
                st["params"] = {k: torch.nextafter(v, torch.where(
                    torch.rand(v.shape, generator=g) < 0.5,
                    torch.full_like(v, -1e30), torch.full_like(v, 1e30)))
                    for k, v in st["params"].items()}
        return st["params"], masks[4:]             # step 2's four tiers
    (pa, ma), (pb, mb) = run(False), run(True)
    low_a, low_b = ma[3]["dec_layers.ln2.w"], mb[3]["dec_layers.ln2.w"]
    assert int((low_a != low_b).sum()) == 1
    assert max((pa[k] - pb[k]).abs().max().item() for k in pa) > 1e-4


def test_checkpoint_crosses_both_ways(tmp_path):
    """The train state (params and AdamW moments under ``enc_layers.*``,
    ``dec_layers.xattn.*``, the norms and the tied embedding) saved by
    the reference's Checkpointer restores in the port's bit for bit, and
    the port's in the reference's."""
    _, _, jp, _ = _ref()
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
    assert "dec_layers.xattn.wk.w" in got["params"]
    for name in want["params"]:
        assert torch.equal(got["params"][name], want["params"][name]), name
        for s in ("m", "v"):
            assert torch.equal(got["opt"][s][name], want["opt"][s][name])
    Checkpointer(str(tmp_path / "port")).save(want, 6)
    back, step = JCheckpointer(str(tmp_path / "port")).restore(
        jax.tree.map(jnp.asarray, zeros))
    assert step == 6
    for part, src in ((back["params"], want["params"]),
                      (back["opt"]["m"], want["opt"]["m"]),
                      (back["opt"]["v"], want["opt"]["v"])):
        flat = params_from_numpy(jax.tree.map(np.asarray, part))
        assert list(flat) == list(src)
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
