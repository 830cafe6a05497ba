"""The reference's keywords that the port once dropped, each held to the
reference: ``window`` through ``make_serve_step``, ``decode_step``,
``attn_decode`` (with ``use_rope``) and the serve launcher;
``ScanEngine.run(participation=)``; ``CohortFLServer.round`` taking
``cohort_batches`` first and ``participation`` second, as the
reference does, by position; ``quantize_int(scale=)``; and
``cross_entropy(mask=)``. The reference's params, shards and inputs
cross over through ``repro_torch.interop`` and numpy seeds."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as j_optim
from repro.configs import get_smoke_config as j_smoke
from repro.configs.paper_mlp import config
from repro.core.compression import DEVICE_TIERS as J_TIERS
from repro.core.engine import ScanEngine as JEngine
from repro.core.federated import Client as JClient
from repro.core.federated import CohortFLServer as JServer
from repro.core.steps import make_serve_step as j_serve_step
from repro.data import make_gaussian_dataset, partition_iid
from repro.models import decoder as JD
from repro.models import get_model as j_get_model
from repro.models import layers as JL
from repro.models import mlp as jmlp
from repro.numerics.float_formats import quantize_int as j_quantize_int
from repro_torch import optim as t_optim
from repro_torch.configs import get_smoke_config
from repro_torch.core.compression import DEVICE_TIERS as T_TIERS
from repro_torch.core.engine import ScanEngine as TEngine
from repro_torch.core.federated import Client as TClient
from repro_torch.core.federated import CohortFLServer as TServer
from repro_torch.core.steps import make_serve_step
from repro_torch.interop import (params_from_numpy, params_to_numpy,
                                 shards_from_numpy)
from repro_torch.launch import serve as serve_mod
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.models import mlp as tmlp
from repro_torch.numerics.float_formats import quantize_int

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
TIERS = ("hub", "mid", "low", "hub", "mid", "low")
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _servers(sample_fraction: float = 1.0):
    """The same six-client fleet (three cohorts of two) in both packages."""
    data = make_gaussian_dataset(KEY, 192)
    shards = partition_iid(KEY, data, len(TIERS))
    params = jmlp.init(KEY, config())
    kw = dict(sample_fraction=sample_fraction, seed=4)
    ref = JServer.from_clients(
        [JClient(i, J_TIERS[t], shards[i], profile_name="mid")
         for i, t in enumerate(TIERS)],
        model=types.SimpleNamespace(loss_fn=jmlp.loss_fn),
        optimizer=j_optim.sgd(0.5), params=params, **kw)
    np_shards = shards_from_numpy([jax.tree.map(np.asarray, s)
                                   for s in shards])
    port = TServer.from_clients(
        [TClient(i, T_TIERS[t], np_shards[i], profile_name="mid")
         for i, t in enumerate(TIERS)], device="cpu",
        model=types.SimpleNamespace(loss_fn=tmlp.loss_fn),
        optimizer=t_optim.sgd(0.5),
        params=params_from_numpy(jax.tree.map(np.asarray, params)), **kw)
    assert [c.size for c in port.cohorts] == [c.size for c in ref.cohorts]
    return ref, port


def _same_params(ref, port):
    jflat = params_from_numpy(jax.tree.map(np.asarray, ref.params))
    for name, a in jflat.items():
        np.testing.assert_allclose(port.params[name].numpy(), a.numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_round_takes_cohort_batches_then_participation_by_position():
    """``round(cohort_batches, participation)`` by position in both
    packages: each cohort's first 12 samples per client, one client of
    each cohort pinned in. Losses rtol 1e-5 and params atol 1e-5 of the
    reference's; the batches change the round (a round on the full data
    with the same participation gives another loss)."""
    ref, port = _servers()
    part = [np.array([True, False]), np.array([False, True]),
            np.array([True, True])]
    jb = [{k: v[:, :12] for k, v in c.data.items()} for c in ref.cohorts]
    tb = [{"x": torch.from_numpy(np.array(b["x"])),
           "y": torch.from_numpy(np.array(b["y"]).astype(np.int64))}
          for b in jb]
    for _ in range(2):
        a = ref.round(jb, part)
        b = port.round(tb, part)
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
        assert b["n_participants"] == a["n_participants"] == 4
    _same_params(ref, port)
    full = _servers()[1].round(None, part)
    assert abs(full["loss"] - port.history[0]["loss"]) > 1e-4


def test_scan_engine_run_pins_participation_per_round():
    """``ScanEngine.run(rounds, participation)``: one list of per-cohort
    masks per round, at chunk_rounds 2 over 3 rounds (the pins split
    across chunks), overriding a sampled fraction of 0.5. Records and
    params as the reference's; a list of the wrong length is refused
    with the reference's message."""
    ref, port = _servers(sample_fraction=0.5)
    pins = [[np.array([True, True]), np.array([False, False]),
             np.array([True, False])],
            [np.array([False, True]), np.array([True, True]),
             np.array([True, True])],
            [np.array([True, False]), np.array([False, True]),
             np.array([False, False])]]
    j_recs = JEngine(ref, chunk_rounds=2).run(3, participation=pins)
    t_recs = TEngine(port, chunk_rounds=2).run(3, participation=pins)
    assert [r["n_participants"] for r in t_recs] == \
        [r["n_participants"] for r in j_recs] == [3, 5, 2]
    np.testing.assert_allclose([r["loss"] for r in t_recs],
                               [r["loss"] for r in j_recs], rtol=1e-5)
    _same_params(ref, port)
    with pytest.raises(ValueError) as j_err:
        JEngine(ref).run(2, participation=pins)
    with pytest.raises(ValueError) as t_err:
        TEngine(port).run(2, participation=pins)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("scale", [None, 0.05, 0.0, "tensor"])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_int_scale_matches_reference(bits, scale):
    """A given scale replaces max|x| / qmax and is floored at 1e-12 like
    it (scale 0 quantizes everything to 0): bitwise the reference."""
    x = _rand(bits, 5, 33, scale=0.3)
    s = np.float32(0.02) if scale == "tensor" else scale
    ref = np.asarray(j_quantize_int(
        jnp.asarray(x), bits, scale=None if s is None else jnp.asarray(s)))
    out = quantize_int(torch.from_numpy(x), bits,
                       scale=None if s is None else torch.tensor(s)).numpy()
    assert np.array_equal(out, ref)


def test_cross_entropy_mask_matches_reference():
    """``sum(nll * mask) / max(sum(mask), 1)`` at rtol/atol 1e-6, a 0/1
    mask and an all-zero one (which gives 0)."""
    logits = _rand(1, 2, 9, 40, scale=3.0)
    labels = np.random.default_rng(2).integers(0, 40, (2, 9)).astype(np.int32)
    for mask in ((np.random.default_rng(3).random((2, 9)) < 0.6)
                 .astype(np.float32), np.zeros((2, 9), np.float32)):
        ref = JL.cross_entropy(*map(jnp.asarray, (logits, labels, mask)))
        out = TL.cross_entropy(*map(torch.from_numpy, (logits, labels, mask)))
        np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6,
                                   atol=1e-6)


@functools.lru_cache(maxsize=None)
def _llama():
    cfg = j_smoke("llama3.2-3b")
    jp = JD.init(jax.random.PRNGKey(0), cfg)
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def test_serve_step_passes_window_like_reference():
    """``make_serve_step(model, window=4)`` and ``decode_step(window=)``
    over 8 positions: logits at rtol/atol 1e-5 of the reference's, which
    ignores the window in decode (a full ring); so do both packages."""
    cfg, jp, tp = _llama()
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             (2, 8)).astype(np.int32)
    j_step = jax.jit(j_serve_step(j_get_model(cfg), window=4))
    model = get_model(get_smoke_config("llama3.2-3b"))
    t_step = make_serve_step(model, window=4)
    jc = JD.init_cache(cfg, 2, 8)
    tc, tc0 = (model.init_cache(2, 8, device="cpu") for _ in range(2))
    for i in range(8):
        a, jc = j_step(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        b, tc = t_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]), i)
        c, tc0 = model.decode_step(tp, tc0, torch.from_numpy(toks[:, i:i + 1]),
                                   i, window=0)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
        assert torch.equal(b, c)


@pytest.mark.parametrize("use_rope", [True, False])
def test_attn_decode_window_and_use_rope_match_reference(use_rope):
    """``attn_decode(..., window=, use_rope=)`` on one layer's attention
    over 5 positions of a 6-slot ring: outputs and cache at rtol/atol
    1e-5."""
    cfg, jp, tp = _llama()
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tl = {k[len("layers.attn."):]: v[0] for k, v in tp.items()
          if k.startswith("layers.attn.")}
    jc = JL.init_kv_cache(2, 6, cfg.num_kv_heads, cfg.head_dim, jnp.float32)
    tc = TL.init_kv_cache(2, 6, cfg.num_kv_heads, cfg.head_dim, torch.float32)
    for pos in range(5):
        x = _rand(10 + pos, 2, 1, cfg.d_model)
        a, jc = JL.attn_decode(jl, jnp.asarray(x), jc, jnp.int32(pos), cfg,
                               window=3, use_rope=use_rope)
        b, tc = TL.attn_decode(tl, torch.from_numpy(x), tc, pos, cfg,
                               window=3, use_rope=use_rope)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    for key in ("k", "v", "slot_pos"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)


def test_serve_launcher_passes_window_to_the_serve_step(monkeypatch):
    """The launcher hands ``--window`` to ``make_serve_step``, as the
    reference's launcher does (``launch/serve.py:60``)."""
    seen = []

    def spy(model, **kw):
        seen.append(kw)
        return make_serve_step(model, **kw)
    monkeypatch.setattr(serve_mod, "make_serve_step", spy)
    res = serve_mod.main(["--arch", "llama3.2-3b", "--smoke", "--batch", "2",
                          "--prompt-len", "6", "--gen", "2", "--window", "4",
                          "--device", "cpu"])
    assert seen == [{"window": 4}] and res["tokens"].shape == (2, 3)


def test_params_to_numpy_round_trip_is_lossless():
    """The interop the tests above rely on: the MLP's params cross and
    come back bit for bit."""
    tp = tmlp.init(torch.Generator().manual_seed(0), config())
    back = params_from_numpy(params_to_numpy(tp))
    assert all(torch.equal(back[k], tp[k]) for k in tp)
