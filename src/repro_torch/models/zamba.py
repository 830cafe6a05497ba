"""Zamba2-style hybrid, as the reference's ``models/zamba.py``: a Mamba2
backbone with ONE shared attention + MLP block (its parameters shared
across applications) applied after every ``cfg.attn_every`` mamba
layers.

Params: ``layers.*`` stacked (num_layers, ...) under the reference's
names (``layers.ln``, ``layers.mamba.in_proj.w``, ...), and the shared
block once under ``shared.*``. Its gradient is the sum over its
applications, which autograd gives when the same tensors are reused.
The reference's ``lax.cond`` on the layer index is a Python ``if``;
application ``(idx + 1) // every - 1`` indexes the stacked KV caches
``attn.{k, v, slot_pos}`` (apps, B, S, Hkv, hd). Decode caches: every
layer's mamba state and the applications' KV caches, written in place.

As in the reference, ``init_cache`` fills the applications' ``slot_pos``
with 0, not -1: a decode step before the cache is full also attends to
the empty slots (k = v = 0), so a replay equals prefill only with a
cache exactly as long as the replayed prompt.
"""
from __future__ import annotations

import torch

from repro_torch.core.scenario import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.decoder import compute_dtype, make_generator
from repro_torch.models.mamba2 import (init_mamba, init_mamba_state,
                                       mamba_decode, mamba_forward)


def n_attn_apps(cfg) -> int:
    return cfg.num_layers // cfg.attn_every


def init(key, cfg, device=None) -> dict:
    """Random params from ``key`` (an int seed or a ``torch.Generator``),
    drawn on the device, in the reference's flatten order."""
    gen = make_generator(key, device)
    dev = gen.device
    params = {
        "embed": L.init_embed(gen, cfg.vocab_size, cfg.d_model),
        "final_norm": torch.ones((cfg.d_model,), device=dev),
        "lm_head.w": L.init_dense(gen, cfg.d_model, cfg.vocab_size,
                                  scale=0.02)["w"],
        "shared.ln1": torch.ones((cfg.d_model,), device=dev),
        "shared.ln2": torch.ones((cfg.d_model,), device=dev),
    }
    params.update({"shared.attn." + k: v
                   for k, v in L.init_attn(gen, cfg).items()})
    params.update({"shared.mlp." + k: v for k, v in L.init_swiglu(
        gen, cfg.d_model, cfg.d_ff, n_attn_apps(cfg)).items()})

    def one_layer():
        return {"ln": torch.ones((cfg.d_model,), device=dev),
                **{"mamba." + k: v for k, v in init_mamba(gen, cfg).items()}}

    params.update({"layers." + k: v for k, v in
                   L.stack_layers(cfg.num_layers, one_layer).items()})
    return dict(sorted(params.items()))


def _views(params: dict):
    """(per-layer views {"ln", "mamba": {...}}, the shared block's view
    {"ln1", "ln2", "attn": {...}, "mlp": {...}})."""
    return ([L.nest(lp) for lp in L.unstack(L.subtree(params, "layers."))],
            L.nest(L.subtree(params, "shared.")))


def _mlp(sp: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    return x + L.swiglu(sp["mlp"], L.rms_norm(x, sp["ln2"], cfg.norm_eps))


def _shared_block(sp: dict, x: torch.Tensor, cfg, window: int):
    h = L.attn_forward(sp["attn"], L.rms_norm(x, sp["ln1"], cfg.norm_eps),
                       cfg, window=window)
    return _mlp(sp, x + h, cfg)


def _shared_block_decode(sp: dict, x: torch.Tensor, cache_a: dict, pos: int,
                         cfg, window: int):
    h, cache_a = L.attn_decode(sp["attn"],
                               L.rms_norm(x, sp["ln1"], cfg.norm_eps),
                               cache_a, pos, cfg, window=window)
    return _mlp(sp, x + h, cfg), cache_a


def _unembed(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.proj(params, "lm_head", x.to(torch.float32))


def _is_app(idx: int, cfg) -> bool:
    """Whether the shared block runs after layer ``idx``."""
    return (idx + 1) % cfg.attn_every == 0


def forward(params: dict, tokens: torch.Tensor, cfg, *, window: int = 0,
            num_groups: int = 1):
    """Returns (logits (B, T, V) f32, aux 0). ``cfg.use_flash`` routes the
    shared block's attention through the flash_attention kernel."""
    x = L.embed(params["embed"], tokens, compute_dtype(cfg))
    layers, sp = _views(params)
    for idx, lp in enumerate(layers):
        y, _ = mamba_forward(lp["mamba"], L.rms_norm(x, lp["ln"],
                                                     cfg.norm_eps), cfg)
        x = x + y
        if _is_app(idx, cfg):
            x = _shared_block(sp, x, cfg, window)
    return _unembed(params, x, cfg), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def loss_fn(params: dict, batch: dict, cfg, *, num_groups: int = 1):
    tokens = batch["tokens"]
    logits, _ = forward(params, tokens[:, :-1], cfg)
    return L.cross_entropy(logits, tokens[:, 1:])


def prefill(params: dict, tokens: torch.Tensor, cfg, *, window: int = 0,
            num_groups: int = 1):
    """Full-sequence forward that fills the mamba states and the shared
    block's KV caches (one per application, slot_pos = arange(T), cache
    length T). Always the chunked attention, as in the reference.
    Returns (last-token logits (B, 1, V), cache)."""
    b, t = tokens.shape
    dt = compute_dtype(cfg)
    x = L.embed(params["embed"], tokens, dt)
    layers, sp = _views(params)
    apps = n_attn_apps(cfg)
    kv0 = L.init_kv_cache(b, t, cfg.num_kv_heads, cfg.head_dim, dt, x.device)
    attn = {k: torch.zeros((apps, *v.shape), dtype=v.dtype, device=x.device)
            for k, v in kv0.items()}
    pos = torch.arange(t, device=x.device)
    mstates = []
    for idx, lp in enumerate(layers):
        y, mstate = mamba_forward(lp["mamba"], L.rms_norm(x, lp["ln"],
                                                          cfg.norm_eps), cfg)
        x = x + y
        mstates.append(mstate)
        if not _is_app(idx, cfg):
            continue
        app = (idx + 1) // cfg.attn_every - 1
        a = sp["attn"]
        h_in = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
        q = L.rope(L.proj(a, "wq", h_in), pos, cfg.rope_theta)
        k = L.rope(L.proj(a, "wk", h_in), pos, cfg.rope_theta)
        v = L.proj(a, "wv", h_in)
        o = L.chunked_attention(q, k, v, causal=True, window=window)
        x = _mlp(sp, x + L.proj(a, "wo", o.reshape(b, t, -1)), cfg)
        attn["k"][app] = k.to(dt)
        attn["v"][app] = v.to(dt)
        attn["slot_pos"][app] = pos.to(torch.int32)
    mamba = {k: torch.stack([s[k] for s in mstates]) for k in mstates[0]}
    return _unembed(params, x[:, -1:, :], cfg), {"mamba": mamba,
                                                 "attn": attn}


def init_cache(cfg, batch: int, cache_len: int, device=None) -> dict:
    """Zero mamba states for every layer and zero KV caches (slot_pos 0,
    as the reference's) for every application."""
    dev = resolve_device(device)
    ms = init_mamba_state(cfg, batch, dev)
    kv = L.init_kv_cache(batch, cache_len, cfg.num_kv_heads, cfg.head_dim,
                         compute_dtype(cfg), dev)
    apps = n_attn_apps(cfg)
    return {
        "mamba": {k: torch.zeros((cfg.num_layers, *v.shape), dtype=v.dtype,
                                 device=dev) for k, v in ms.items()},
        "attn": {k: torch.zeros((apps, *v.shape), dtype=v.dtype, device=dev)
                 for k, v in kv.items()},
    }


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                cfg, *, window: int = 0, num_groups: int = 1):
    """One decode step (tokens (B, 1)); the cache is written in place.
    Returns (logits (B, 1, V), cache)."""
    x = L.embed(params["embed"], tokens, compute_dtype(cfg))
    layers, sp = _views(params)
    mc, ac = cache["mamba"], cache["attn"]
    for idx, lp in enumerate(layers):
        y, new = mamba_decode(lp["mamba"], L.rms_norm(x, lp["ln"],
                                                      cfg.norm_eps),
                              {k: v[idx] for k, v in mc.items()}, cfg)
        for k, v in new.items():
            mc[k][idx].copy_(v)
        x = x + y
        if _is_app(idx, cfg):
            app = (idx + 1) // cfg.attn_every - 1
            x, _ = _shared_block_decode(sp, x, {k: v[app] for k, v in
                                                ac.items()}, int(pos), cfg,
                                        window)
    return _unembed(params, x, cfg), cache
