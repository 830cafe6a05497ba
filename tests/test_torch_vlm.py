"""Port parity for the VLM family (llava-next-34b's backbone with stub
patch embeddings), on the CPU: the projector leaf, the decoder's
forward, loss, prefill with patches and decode, the synthetic VLM
batches, two tier-loop AdamW steps, decode against prefill, and the
serve and train entry points. The reference's params cross over through
``repro_torch.interop``; inputs come from numpy seeds."""
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
from repro.core.steps import make_hetero_train_step as j_hetero_step
from repro.data.synthetic import make_train_batch as j_batch
from repro.models import decoder as JD
from repro.models import get_model as j_get_model
from repro_torch import optim as topt
from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.core.compression import (DEVICE_TIERS, compress_params,
                                          compressible, default_tier_plans)
from repro_torch.core.steps import make_hetero_train_step
from repro_torch.data.synthetic import make_train_batch
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import decoder as TD
from repro_torch.models import get_model

torch.set_num_threads(1)

ARCH = "llava-next-34b"
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@functools.lru_cache(maxsize=None)
def _ref_params(seed: int = 0):
    jp = JD.init(jax.random.PRNGKey(seed), j_smoke(ARCH))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _inputs(seed: int, b: int = 2, t: int = 9):
    cfg = j_smoke(ARCH)
    rng = np.random.default_rng(seed)
    patches = rng.standard_normal((b, cfg.num_patches, cfg.d_model)) \
        .astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    return patches, toks


def test_vlm_param_leaves_match_reference():
    """The reference's 13 leaves, ``projector.w`` (D, D) with no bias
    among them, under the same names, order and shapes; the projector
    compresses like any matrix leaf."""
    _, tp = _ref_params()
    cfg = get_smoke_config(ARCH)
    mine = TD.init(0, cfg, device="cpu")
    assert list(mine) == list(tp) and len(tp) == 13
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    assert tuple(tp["projector.w"].shape) == (cfg.d_model, cfg.d_model)
    assert "projector.b" not in tp
    assert compressible("projector.w", tp["projector.w"])


@pytest.mark.parametrize("use_flash", [False, True])
def test_vlm_forward_and_loss_match_reference(use_flash):
    """Logits over P + T positions and the loss (patch positions carry
    none) at rtol/atol 1e-5."""
    jcfg = j_smoke(ARCH).replace(use_flash=use_flash)
    tcfg = get_smoke_config(ARCH).replace(use_flash=use_flash)
    jp, tp = _ref_params()
    patches, toks = _inputs(1)
    jl, _ = jax.jit(functools.partial(JD.forward, cfg=jcfg))(
        jp, jnp.asarray(toks[:, :-1]), patches=jnp.asarray(patches))
    jloss = jax.jit(functools.partial(JD.loss_fn, cfg=jcfg))(
        jp, {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)})
    tl, ta = TD.forward(tp, _t(toks[:, :-1]), tcfg, patches=_t(patches))
    tloss = TD.loss_fn(tp, {"tokens": _t(toks), "patches": _t(patches)},
                       tcfg)
    assert tl.shape == (2, jcfg.num_patches + 8, jcfg.vocab_size)
    assert ta.item() == 0.0
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)


def test_vlm_prefill_with_patches_and_decode_match_reference():
    """Prefill over patches + prompt: last-token logits and the P + T
    cache at rtol/atol 1e-5; then decode steps that continue that cache
    past the patches, logits at rtol/atol 1e-5."""
    cfg, tcfg = j_smoke(ARCH), get_smoke_config(ARCH)
    jp, tp = _ref_params()
    model = get_model(tcfg)
    patches, toks = _inputs(2, t=8)
    p = cfg.num_patches
    jl, jcache = jax.jit(functools.partial(JD.prefill, cfg=cfg))(
        jp, jnp.asarray(toks[:, :5]), patches=jnp.asarray(patches))
    tl, tcache = model.prefill(tp, {"tokens": _t(toks[:, :5]),
                                    "patches": _t(patches)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcache["layers"]["k"].shape[2] == p + 5
    for key in ("k", "v", "slot_pos"):
        np.testing.assert_allclose(tcache["layers"][key].numpy(),
                                   np.asarray(jcache["layers"][key]), **TOL)
    # both decode on from the reference's prefill cache, in a ring of
    # P + 8 slots
    ring = {k: np.array(v) for k, v in JD.init_cache(cfg, 2, p + 8)[
        "layers"].items()}
    for k in ("k", "v"):
        ring[k][:, :, :p + 5] = np.asarray(jcache["layers"][k])
    ring["slot_pos"][:, :p + 5] = np.asarray(jcache["layers"]["slot_pos"])
    jc = {"layers": {k: jnp.asarray(v) for k, v in ring.items()}}
    tc = {"layers": {k: torch.from_numpy(v.copy()) for k, v in ring.items()}}
    j_decode = jax.jit(functools.partial(JD.decode_step, cfg=cfg))
    for i in range(5, 8):
        a, jc = j_decode(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                         jnp.int32(p + i))
        b, tc = model.decode_step(tp, tc, _t(toks[:, i:i + 1]), p + i)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_vlm_decode_replay_matches_text_prefill():
    """The serve path's replay sees only the text, as in the reference:
    its last logits equal a prefill of the same prompt without patches
    (rtol/atol 2e-4), and the patches move prefill's logits by O(1)."""
    cfg = get_smoke_config(ARCH)
    res = serve_mod.serve(cfg, "hub", batch=2, prompt_len=8, gen=1,
                          device="cpu", seed=3)
    model = get_model(cfg)
    params = model.init(3, device="cpu")
    prompt = serve_mod.TokenStream(cfg.vocab_size, 2, 8, seed=3) \
        .batch_at(0)["tokens"][:, :8]
    text, _ = model.prefill(params, {"tokens": prompt})
    np.testing.assert_allclose(res["replay_logits"].numpy(), text.numpy(),
                               rtol=2e-4, atol=2e-4)
    moved = (res["prefill_logits"] - text).abs().max().item()
    assert moved > 1e-2, moved


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_tiers", [0, 4])
def test_vlm_train_batch_bitwise(n_tiers, dtype):
    """Patches (drawn first, rounded to the config's dtype) and the
    T - P + 1 text tokens, bitwise the reference's."""
    cfg = get_smoke_config(ARCH).replace(dtype=dtype)
    jcfg = j_smoke(ARCH).replace(dtype=dtype)
    a = make_train_batch(cfg, ShapeConfig("t", 16, 8, "train"),
                         n_tiers=n_tiers, seed=2, index=5)
    b = j_batch(jcfg, JShape("t", 16, 8, "train"), n_tiers=n_tiers, seed=2,
                index=5)
    lead = (4, 2) if n_tiers else (8,)
    assert a["patches"].shape == (*lead, cfg.num_patches, cfg.d_model)
    assert a["patches"].dtype == getattr(torch, dtype)
    assert a["tokens"].shape == (*lead, 16 - cfg.num_patches + 1)
    assert np.array_equal(a["tokens"].numpy(), np.asarray(b["tokens"]))
    got = a["patches"].view(torch.int16 if dtype == "bfloat16"
                            else torch.int32).numpy()
    ref = np.asarray(b["patches"]).view(np.int16 if dtype == "bfloat16"
                                        else np.int32)
    assert np.array_equal(got, ref)


def test_vlm_hetero_train_steps_match_reference():
    """Two tier-loop steps under AdamW(warmup_cosine(3e-4, 1, 2)) with
    flash attention on llava's smoke config, patches in every tier's
    batch: mean losses at rtol 1e-4, params after the two steps at atol
    1e-5, each leaf moved, the projector compressed per tier."""
    jcfg = j_smoke(ARCH).replace(use_flash=True)
    tcfg = get_smoke_config(ARCH).replace(use_flash=True)
    jo = jopt.adamw(jopt.warmup_cosine(3e-4, 1, 2))
    to = topt.adamw(topt.warmup_cosine(3e-4, 1, 2))
    jstep = jax.jit(j_hetero_step(j_get_model(jcfg), jo,
                                  JC.default_tier_plans(4)))
    tstep = make_hetero_train_step(get_model(tcfg), to,
                                   default_tier_plans(4))
    jp, tp = _ref_params()
    js = dict(params=jp, opt=jo.init(jp), step=jnp.zeros((), jnp.int32))
    ts = dict(params=tp, opt=to.init(tp),
              step=torch.zeros((), dtype=torch.int32))
    for i in range(2):
        shape = dict(n_tiers=4, seed=4, index=i)
        b = make_train_batch(tcfg, ShapeConfig("t", 16, 8, "train"), **shape)
        jb = j_batch(jcfg, JShape("t", 16, 8, "train"), **shape)
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, b)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4)
    jflat = params_from_numpy(jax.tree.map(np.asarray, js["params"]))
    for name, a in jflat.items():
        np.testing.assert_allclose(ts["params"][name].numpy(), a.numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
        assert not torch.equal(ts["params"][name], tp[name]), name
    _, masks = compress_params(tp, DEVICE_TIERS["low"])
    assert masks["projector.w"].shape == tp["projector.w"].shape


def test_vlm_entry_points_run_on_cpu():
    res = serve_mod.main(["--arch", ARCH, "--smoke", "--tier", "mid",
                          "--batch", "2", "--prompt-len", "6", "--gen", "3",
                          "--device", "cpu"])
    assert res["tokens"].shape == (2, 4)
    assert torch.isfinite(res["prefill_logits"]).all()
    res = train_mod.main(["--arch", ARCH, "--smoke", "--steps", "2",
                          "--batch", "4", "--seq", "16", "--device", "cpu",
                          "--use-flash", "--log-every", "1"])
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
