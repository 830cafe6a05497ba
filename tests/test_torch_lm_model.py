"""Port parity for the dense LM, on the CPU: layers, the decoder's
forward and loss for every ported dense arch (chunked and flash
attention), the synthetic token stream, the LR schedules, and the
launch entry points. The reference's params cross over through
``repro_torch.interop``; inputs come from numpy seeds."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.core import compression as JC
from repro.data.synthetic import TokenStream as JStream
from repro.data.synthetic import make_train_batch as j_batch
from repro.models import decoder as JD
from repro.models import layers as JL
from repro.optim import warmup_cosine as j_warmup_cosine
from repro_torch import optim
from repro_torch.configs import ARCHS, ShapeConfig, get_config, get_smoke_config
from repro_torch.core.compression import (DEVICE_TIERS, default_tier_plans,
                                          plan_arrays)
from repro_torch.data.synthetic import TokenStream, make_train_batch
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import decoder as TD
from repro_torch.models import get_model
from repro_torch.models import layers as TL

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_dense_configs_match_reference():
    """Every arch of the reference is registered, in the reference's
    order, and its smoke config is the reference's."""
    assert ARCHS == J_ARCHS
    for arch in ARCHS:
        assert vars(get_smoke_config(arch)) == vars(j_smoke(arch))
    full = get_config("llama3.2-3b")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size) == \
        (28, 3072, 24, 8, 128, 8192, 128256)


def test_layers_match_reference():
    """rms_norm, layer_norm, rope, swiglu and cross_entropy at rtol/atol
    1e-5."""
    x = _rand(0, 2, 5, 4, 16)
    w, b = _rand(1, 16), _rand(8, 16)
    np.testing.assert_allclose(
        TL.rms_norm(_t(x), _t(w)).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    np.testing.assert_allclose(
        TL.layer_norm(_t(x), _t(w), _t(b)).numpy(),
        np.asarray(JL.layer_norm(*map(jnp.asarray, (x, w, b)))), **TOL)
    pos = np.arange(5, dtype=np.int32) + 3
    np.testing.assert_allclose(
        TL.rope(_t(x), _t(pos), 5e5).numpy(),
        np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 5e5)), **TOL)
    p = {"wg": {"w": _rand(2, 16, 24, scale=0.25)},
         "wi": {"w": _rand(3, 16, 24, scale=0.25)},
         "wo": {"w": _rand(4, 24, 16, scale=0.2)}}
    tp = {f"{k}.w": _t(v["w"]) for k, v in p.items()}
    xs = _rand(5, 3, 7, 16)
    np.testing.assert_allclose(
        TL.swiglu(tp, _t(xs)).numpy(),
        np.asarray(JL.swiglu(jax.tree.map(jnp.asarray, p), jnp.asarray(xs))),
        **TOL)
    logits = _rand(6, 2, 9, 50, scale=3.0)
    labels = np.random.default_rng(7).integers(0, 50, (2, 9)).astype(np.int32)
    np.testing.assert_allclose(
        TL.cross_entropy(_t(logits), _t(labels)).numpy(),
        np.asarray(JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
        **TOL)


@pytest.mark.parametrize("causal,window,q_chunk", [(True, 0, 16), (True, 5, 8),
                                                   (False, 0, 32)])
def test_chunked_attention_matches_reference(causal, window, q_chunk):
    q, k, v = _rand(0, 2, 32, 6, 8), _rand(1, 2, 32, 2, 8), _rand(2, 2, 32, 2, 8)
    ref = JL.chunked_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                               window=window, q_chunk=q_chunk)
    out = TL.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                               window=window, q_chunk=q_chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_decode_attention_and_cache_update_match_reference():
    """Ring cache of 6 slots written at positions 0..7 (two wrap), then
    single-token attention, at rtol/atol 1e-5; the in-place slot write
    gives the reference's masked-select cache exactly."""
    jc = JL.init_kv_cache(2, 6, 2, 8, jnp.float32)
    tc = TL.init_kv_cache(2, 6, 2, 8, torch.float32)
    for pos in range(8):
        kn, vn = _rand(10 + pos, 2, 1, 2, 8), _rand(20 + pos, 2, 1, 2, 8)
        jc = JL.kv_cache_update(jc, jnp.asarray(kn), jnp.asarray(vn),
                                jnp.int32(pos))
        tc = TL.kv_cache_update(tc, _t(kn), _t(vn), pos)
    for key in ("k", "v", "slot_pos"):
        assert np.array_equal(tc[key].numpy(), np.asarray(jc[key]))
    q = _rand(30, 2, 1, 4, 8)
    np.testing.assert_allclose(
        TL.decode_attention(_t(q), tc).numpy(),
        np.asarray(JL.decode_attention(jnp.asarray(q), jc)), **TOL)


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str, seed: int = 0):
    cfg = j_smoke(arch)
    jp = JD.init(jax.random.PRNGKey(seed), cfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def test_param_leaves_match_reference():
    """The same 11 stacked leaves under the same names and order (10 of
    them compressible), qwen's q/k/v biases included."""
    for arch in ("llama3.2-3b", "qwen2.5-32b"):
        jp, tp = _ref_params(arch)
        mine = TD.init(0, get_smoke_config(arch), device="cpu")
        assert list(mine) == list(tp)
        assert {k: tuple(v.shape) for k, v in mine.items()} == \
            {k: tuple(v.shape) for k, v in tp.items()}
    assert len(_ref_params("llama3.2-3b")[1]) == 11


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("arch", ["granite-3-2b", "llama3.2-3b", "deepseek-7b",
                                  "qwen2.5-32b"])
def test_forward_and_loss_match_reference(arch, use_flash):
    """Logits and loss at rtol/atol 1e-5, f32 smoke configs."""
    jcfg = j_smoke(arch).replace(use_flash=use_flash)
    tcfg = get_smoke_config(arch).replace(use_flash=use_flash)
    jp, tp = _ref_params(arch)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             (2, 17)).astype(np.int32)
    jlogits, _ = jax.jit(functools.partial(JD.forward, cfg=jcfg))(
        jp, jnp.asarray(toks[:, :-1]))
    jloss = jax.jit(functools.partial(JD.loss_fn, cfg=jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    tlogits, _ = TD.forward(tp, _t(toks[:, :-1]), tcfg)
    tloss = TD.loss_fn(tp, {"tokens": _t(toks)}, tcfg)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)


def test_token_stream_and_train_batch_bitwise():
    js, ts = JStream(512, 3, 20, seed=5), TokenStream(512, 3, 20, seed=5)
    for i in (0, 7):
        assert np.array_equal(ts.batch_at(i)["tokens"].numpy(),
                              np.asarray(js.batch_at(i)["tokens"]))
    cfg = get_smoke_config("llama3.2-3b")
    for n_tiers in (0, 4):
        a = make_train_batch(cfg, ShapeConfig("t", 16, 8, "train"),
                             n_tiers=n_tiers, seed=2, index=3)["tokens"]
        b = j_batch(j_smoke("llama3.2-3b"), JShape("t", 16, 8, "train"),
                    n_tiers=n_tiers, seed=2, index=3)["tokens"]
        assert a.dtype == torch.int32 and np.array_equal(a.numpy(),
                                                         np.asarray(b))


def test_plan_arrays_match_reference():
    plans = JC.default_tier_plans(5)
    ref = JC.plan_arrays(plans)
    out = plan_arrays(default_tier_plans(5))
    for key, col in out.items():
        assert np.array_equal(np.asarray(col, np.asarray(ref[key]).dtype),
                              np.asarray(ref[key])), key
    with pytest.raises(ValueError, match="structured"):
        plan_arrays([DEVICE_TIERS["mid"].as_width_sliced()])


def test_warmup_cosine_matches_reference():
    """f32 over steps 0..50 at rtol 1e-6: XLA's and torch's cos may differ
    by an ulp."""
    jf, tf = j_warmup_cosine(3e-4, 5, 40), optim.warmup_cosine(3e-4, 5, 40)
    for step in range(51):
        a = np.float32(jf(jnp.int32(step)))
        b = tf(torch.tensor(step, dtype=torch.int32))
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.item(), a, rtol=1e-6, atol=0)
    assert optim.constant(0.5)(3).item() == 0.5


def test_serve_and_train_entry_points_run_on_cpu(capsys):
    res = serve_mod.main(["--arch", "llama3.2-3b", "--smoke", "--tier", "low",
                          "--batch", "2", "--prompt-len", "8", "--gen", "4",
                          "--device", "cpu"])
    assert res["tokens"].shape == (2, 5)
    assert torch.isfinite(res["prefill_logits"]).all()
    res = train_mod.main(["--arch", "granite-3-2b", "--smoke", "--steps", "2",
                          "--batch", "4", "--seq", "16", "--device", "cpu",
                          "--use-flash", "--log-every", "1"])
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert "done" in capsys.readouterr().out


def test_entry_points_never_drop_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_mod.main(["--arch", "llama3.2-3b", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.main(["--arch", "llama3.2-3b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(get_smoke_config("llama3.2-3b")).init(0)
    # --model-parallel 2 on the CPU: a (1, 1) host mesh of the CPU alone,
    # which needs no GPU (it raised NotImplementedError before the meshes
    # were ported)
    res = train_mod.main(["--arch", "llama3.2-3b", "--smoke", "--steps", "1",
                          "--batch", "4", "--seq", "8", "--device", "cpu",
                          "--model-parallel", "2"])
    assert len(res["losses"]) == 1 and np.isfinite(res["losses"][0])


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_launcher_mesh_is_its_device_alone_on_a_multi_card_host(
        monkeypatch, model_parallel):
    """On a host that reports four cards the launcher's mesh is still
    (1, 1) over the device it trains on: a mesh over every card would
    make ``place`` refuse the state (several distinct devices)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    meshes = []
    make = train_mod.make_host_mesh

    def spy(*a, **k):
        meshes.append(make(*a, **k))
        return meshes[-1]
    monkeypatch.setattr(train_mod, "make_host_mesh", spy)
    res = train_mod.train(get_smoke_config("llama3.2-3b"), steps=1, batch=4,
                          seq=8, device="cpu", model_parallel=model_parallel)
    assert len(res["losses"]) == 1 and np.isfinite(res["losses"][0])
    (mesh,) = meshes
    assert dict(mesh.shape) == {"data": 1, "model": 1}
    assert mesh.distinct_devices() == [torch.device("cpu")]
