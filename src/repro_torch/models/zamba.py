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

On a mesh of several ranks the train loss runs on each rank's blocks of
the leaves, split over "model" by the reference's ``param_spec_tree``:
the Mamba2 layers as ``mamba2.mamba_forward`` says, the shared block's
attention and MLP as the decoder's (``layers.attn_forward``,
``layers.swiglu``), the embedding and ``lm_head`` on the vocabulary.
Prefill and decode run there on each rank's blocks of the deployed
params and of the cache (:func:`prefill`, :func:`decode_step`).

As in the reference, ``init_cache`` fills the applications' ``slot_pos``
with 0, not -1: a decode step before the cache is full also attends to
the empty slots (k = v = 0), so a replay equals prefill only with a
cache exactly as long as the replayed prompt.
"""
from __future__ import annotations

import torch

from repro_torch.core.scenario import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.decoder import (compute_dtype, head_layout,
                                        make_generator, serve_logits,
                                        unembed_head, vocab_layout)
from repro_torch.models.mamba2 import dims as mamba_dims
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
    split = sp["mlp"]["wi.w"].shape[-1] != cfg.d_ff
    return x + L.swiglu(sp["mlp"], L.rms_norm(x, sp["ln2"], cfg.norm_eps),
                        split=split)


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


def _is_app(idx: int, cfg) -> bool:
    """Whether the shared block runs after layer ``idx``."""
    return (idx + 1) % cfg.attn_every == 0


def forward(params: dict, tokens: torch.Tensor, cfg, *, window: int = 0,
            num_groups: int = 1):
    """Returns (logits (B, T, V) f32, aux 0). ``cfg.use_flash`` routes the
    shared block's attention through the flash_attention kernel. On a
    mesh of several ranks the logits are this rank's block of the
    vocabulary where ``lm_head.w`` splits it (:func:`decoder.head_layout`)."""
    x = L.embed(params["embed"], tokens, compute_dtype(cfg),
                vocab_layout(params["embed"], cfg, 0))
    layers, sp = _views(params)
    for idx, lp in enumerate(layers):
        y, _ = mamba_forward(lp["mamba"], L.rms_norm(x, lp["ln"],
                                                     cfg.norm_eps), cfg)
        x = x + y
        if _is_app(idx, cfg):
            x = _shared_block(sp, x, cfg, window)
    return unembed_head(params, x, cfg, head_layout(params, cfg)), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params: dict, batch: dict, cfg, *, num_groups: int = 1):
    tokens = batch["tokens"]
    logits, _ = forward(params, tokens[:, :-1], cfg)
    return L.cross_entropy(logits, tokens[:, 1:], vocab_split=head_layout(
        params, cfg) == L.VOCAB)


def prefill(params: dict, tokens: torch.Tensor, cfg, *, window: int = 0,
            num_groups: int = 1):
    """Full-sequence forward that fills the mamba states and the shared
    block's KV caches (one per application, slot_pos = arange(T), cache
    length T). Always the chunked attention, as in the reference.
    Returns (last-token logits (B, 1, V), cache).

    On a mesh of several ranks each state is cut to this rank's block of
    the cache as ``sharding.cache_spec_tree`` places it
    (``layers.cache_block``): a layer's ``conv`` on its channels, its
    ``ssm`` on its heads (already so where the scan ran this rank's
    heads), the applications' k and v on the sequence axis, else the kv
    heads, else head_dim (``layers.attn_prefill``)."""
    b, t = tokens.shape
    dt = compute_dtype(cfg)
    x = L.embed(params["embed"], tokens, dt,
                vocab_layout(params["embed"], cfg, 0))
    layers, sp = _views(params)
    _, nheads, _ = mamba_dims(cfg)
    ssm_whole = (b, nheads, cfg.ssm_headdim, cfg.ssm_state)
    pos = torch.arange(t, device=x.device)
    mstates, kvs = [], {"k": [], "v": []}
    for idx, lp in enumerate(layers):
        y, mstate = mamba_forward(lp["mamba"], L.rms_norm(x, lp["ln"],
                                                          cfg.norm_eps), cfg)
        x = x + y
        mstates.append({"conv": L.cache_block(mstate["conv"], "conv"),
                        "ssm": L.cache_block(mstate["ssm"], "ssm",
                                             ssm_whole)})
        if not _is_app(idx, cfg):
            continue
        h, k, v = L.attn_prefill(sp["attn"],
                                 L.rms_norm(x, sp["ln1"], cfg.norm_eps), cfg,
                                 window=window, positions=pos)
        x = _mlp(sp, x + h, cfg)
        k, v = L.cache_block(k.to(dt), "k"), L.cache_block(v.to(dt), "v")
        kvs["k"].append(k)
        kvs["v"].append(v)
    apps = n_attn_apps(cfg)
    attn = {k: torch.stack(v) if v else torch.zeros(
        (0, b, t, cfg.num_kv_heads, cfg.head_dim), dtype=dt, device=x.device)
        for k, v in kvs.items()}
    attn["slot_pos"] = pos.to(torch.int32).expand(apps, t).contiguous()
    mamba = {k: torch.stack([s[k] for s in mstates]) for k in mstates[0]}
    return serve_logits(params, x[:, -1:, :], cfg), {"mamba": mamba,
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
    Returns (logits (B, 1, V), cache). On a mesh of several ranks the
    cache is this rank's block (:func:`prefill`): the Mamba2 layers run
    as ``mamba2.mamba_decode`` says, the shared block's attention as
    ``layers.attn_decode``."""
    x = L.embed(params["embed"], tokens, compute_dtype(cfg),
                vocab_layout(params["embed"], cfg, 0))
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
    return serve_logits(params, x, cfg), cache
