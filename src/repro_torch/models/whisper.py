"""Whisper-style encoder-decoder (transformer backbone only), as the
reference's ``models/whisper.py``.

The mel-spectrogram + conv feature extractor is a stub: inputs are
precomputed frame embeddings (B, encoder_seq, d_model). The model is the
4+4 layer pre-LN encoder-decoder with cross-attention, GELU MLPs and
sinusoidal positions (in place of the learned table).

Params: ``enc_layers.*`` and ``dec_layers.*`` stacked (L, ...) under the
reference's names (``enc_layers.attn.wq.w``, ``dec_layers.xattn.wk.w``,
``dec_layers.ln_x.b``, ...), ``enc_norm.{b,w}``, ``dec_norm.{b,w}`` and
the tied ``embed``. The reference's ``lax.scan`` over layers is a Python
loop over ``unstack``ed views; its sharding ``hint``s and ``remat`` have
no meaning here (``decode_train`` takes ``remat`` and ignores it).

``cfg.use_flash`` routes the encoder's self-attention, the decoder's
self-attention in training and every cross-attention of training and
prefill through the flash_attention kernel (non-causal over the encoder's
frames); ``prefill``'s decoder self-attention is always the chunked
attention, as in the reference. Decode caches: the decoder's ring KV
caches ``k``, ``v``, ``slot_pos`` and the cross-KV ``enc_k`` / ``enc_v``
(L, B, encoder_seq, Hkv, hd), stacked over layers; ``decode_step``
writes the self-KV in place.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.scenario import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.decoder import compute_dtype, make_generator


def sinusoid_freq(d_model: int, device=None) -> torch.Tensor:
    """The (d_model // 2,) f32 frequencies of :func:`sinusoid`. XLA's and
    torch's f32 ``exp`` differ by an ulp on some of these entries, which
    the angle ``pos * freq`` carries up to ~pos times."""
    half = d_model // 2
    return torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / half)


def sinusoid(positions: torch.Tensor, d_model: int, dtype) -> torch.Tensor:
    """positions: (T,) int -> (T, D): [sin(pos * freq), cos(pos * freq)]."""
    freq = sinusoid_freq(d_model, positions.device)
    ang = positions.to(torch.float32)[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _norm(d: int, dev) -> dict:
    return {"b": torch.zeros((d,), device=dev),
            "w": torch.ones((d,), device=dev)}


def init(key, cfg, device=None) -> dict:
    """Random params from ``key`` (an int seed or a ``torch.Generator``),
    drawn on the device, in the reference's flatten order."""
    gen = make_generator(key, device)
    dev = gen.device
    d = cfg.d_model

    def enc_layer():
        return {**L._named("ln1.", _norm(d, dev)),
                **L._named("attn.", L.init_attn(gen, cfg)),
                **L._named("ln2.", _norm(d, dev)),
                **L._named("mlp.", L.init_gelu_mlp(gen, d, cfg.d_ff))}

    def dec_layer():
        return {**L._named("ln1.", _norm(d, dev)),
                **L._named("attn.", L.init_attn(gen, cfg)),
                **L._named("ln_x.", _norm(d, dev)),
                **L._named("xattn.", L.init_attn(gen, cfg)),
                **L._named("ln2.", _norm(d, dev)),
                **L._named("mlp.", L.init_gelu_mlp(gen, d, cfg.d_ff))}

    params = {
        "embed": L.init_embed(gen, cfg.vocab_size, d),
        **L._named("enc_layers.",
                   L.stack_layers(cfg.encoder_layers, enc_layer)),
        **L._named("enc_norm.", _norm(d, dev)),
        **L._named("dec_layers.", L.stack_layers(cfg.num_layers, dec_layer)),
        **L._named("dec_norm.", _norm(d, dev)),
    }
    return dict(sorted(params.items()))


def _layers(params: dict, prefix: str) -> list[dict]:
    """Per-layer nested views {"ln1": {"b", "w"}, "attn": {...}, ...}."""
    return [L.nest(lp) for lp in L.unstack(L.subtree(params, prefix))]


def _ln(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    return L.layer_norm(x, p["w"], p["b"], eps)


def _add_positions(x: torch.Tensor, positions: torch.Tensor,
                   cfg) -> torch.Tensor:
    return x + sinusoid(positions, cfg.d_model, x.dtype)[None]


def encode(params: dict, frames: torch.Tensor, cfg) -> torch.Tensor:
    """frames: (B, S_enc, D) stub embeddings -> (B, S_enc, D)."""
    x = frames.to(compute_dtype(cfg))
    x = _add_positions(x, torch.arange(x.shape[1], device=x.device), cfg)
    for lp in _layers(params, "enc_layers."):
        x = x + L.attn_forward(lp["attn"], _ln(lp["ln1"], x, cfg.norm_eps),
                               cfg, causal=False, use_rope=False)
        x = x + L.gelu_mlp(lp["mlp"], _ln(lp["ln2"], x, cfg.norm_eps))
    return _ln(L.subtree(params, "enc_norm."), x, cfg.norm_eps)


def _dec_block(lp: dict, x: torch.Tensor, enc_x: torch.Tensor, cfg,
               window: int) -> torch.Tensor:
    x = x + L.attn_forward(lp["attn"], _ln(lp["ln1"], x, cfg.norm_eps), cfg,
                           window=window, use_rope=False)
    x = x + L.attn_forward(lp["xattn"], _ln(lp["ln_x"], x, cfg.norm_eps),
                           cfg, kv_src=enc_x, use_rope=False, causal=False)
    return x + L.gelu_mlp(lp["mlp"], _ln(lp["ln2"], x, cfg.norm_eps))


def _logits(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    x = _ln(L.subtree(params, "dec_norm."), x, cfg.norm_eps)
    return L.unembed(x, params["embed"])


def decode_train(params: dict, enc_x: torch.Tensor, tokens: torch.Tensor,
                 cfg, *, window: int = 0, remat: bool = True) -> torch.Tensor:
    """Teacher-forced decoder over ``tokens`` (B, T) attending to
    ``enc_x``: logits (B, T, V) f32."""
    x = L.embed(params["embed"], tokens, compute_dtype(cfg))
    x = _add_positions(x, torch.arange(x.shape[1], device=x.device), cfg)
    for lp in _layers(params, "dec_layers."):
        x = _dec_block(lp, x, enc_x, cfg, window)
    return _logits(params, x, cfg)


def loss_fn(params: dict, batch: dict, cfg, *, num_groups: int = 1):
    """batch: {"frames": (B, S_enc, D), "tokens": (B, T+1)}."""
    enc_x = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    logits = decode_train(params, enc_x, tokens[:, :-1], cfg)
    return L.cross_entropy(logits, tokens[:, 1:])


def prefill(params: dict, batch: dict, cfg, *, window: int = 0,
            num_groups: int = 1):
    """Encode the frames and run the decoder over the whole token prefix,
    filling the self-KV caches (slot_pos = arange(T), cache length T) and
    the cross-KV. Returns (last-token logits (B, 1, V), cache)."""
    enc_x = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    b, t = tokens.shape
    x = L.embed(params["embed"], tokens, compute_dtype(cfg))
    x = _add_positions(x, torch.arange(t, device=x.device), cfg)
    kv = {"k": [], "v": [], "enc_k": [], "enc_v": []}
    for lp in _layers(params, "dec_layers."):
        a = lp["attn"]
        h_in = _ln(lp["ln1"], x, cfg.norm_eps)
        k, v = L.proj(a, "wk", h_in), L.proj(a, "wv", h_in)
        o = L.chunked_attention(L.proj(a, "wq", h_in), k, v, causal=True,
                                window=window)
        x = x + L.proj(a, "wo", o.reshape(b, t, -1))
        x = x + L.attn_forward(lp["xattn"], _ln(lp["ln_x"], x, cfg.norm_eps),
                               cfg, kv_src=enc_x, use_rope=False,
                               causal=False)
        x = x + L.gelu_mlp(lp["mlp"], _ln(lp["ln2"], x, cfg.norm_eps))
        for name, val in (("k", k), ("v", v),
                          ("enc_k", L.proj(lp["xattn"], "wk", enc_x)),
                          ("enc_v", L.proj(lp["xattn"], "wv", enc_x))):
            kv[name].append(val)
    cache = {k: torch.stack(v) for k, v in kv.items()}
    cache["slot_pos"] = torch.arange(t, dtype=torch.int32, device=x.device) \
        .expand(cfg.num_layers, t).clone()
    return _logits(params, x[:, -1:, :], cfg), {"layers": cache}


def init_cache(cfg, batch: int, cache_len: int, device=None) -> dict:
    """Zero self-KV rings (slot_pos -1) of ``cache_len`` slots and zero
    cross-KV of ``encoder_seq`` rows, for every decoder layer."""
    dev = resolve_device(device)
    dt = compute_dtype(cfg)
    hkv, hd, ld = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    return {"layers": {
        "k": torch.zeros((ld, batch, cache_len, hkv, hd), dtype=dt,
                         device=dev),
        "v": torch.zeros((ld, batch, cache_len, hkv, hd), dtype=dt,
                         device=dev),
        "slot_pos": torch.full((ld, cache_len), -1, dtype=torch.int32,
                               device=dev),
        "enc_k": torch.zeros((ld, batch, cfg.encoder_seq, hkv, hd),
                             dtype=dt, device=dev),
        "enc_v": torch.zeros((ld, batch, cfg.encoder_seq, hkv, hd),
                             dtype=dt, device=dev),
    }}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                cfg, *, window: int = 0, num_groups: int = 1):
    """One decode step (tokens (B, 1)) against the cached cross-KV; the
    self-KV is written in place. Returns (logits (B, 1, V), cache)."""
    x = L.embed(params["embed"], tokens, compute_dtype(cfg))
    x = _add_positions(x, torch.full((1,), int(pos), dtype=torch.int32,
                                     device=x.device), cfg)
    cl = cache["layers"]
    for i, lp in enumerate(_layers(params, "dec_layers.")):
        self_cl = {k: cl[k][i] for k in ("k", "v", "slot_pos")}
        h, _ = L.attn_decode(lp["attn"], _ln(lp["ln1"], x, cfg.norm_eps),
                             self_cl, int(pos), cfg, window=window,
                             use_rope=False)
        x = x + h
        x = x + L.cross_attn_decode(lp["xattn"],
                                    _ln(lp["ln_x"], x, cfg.norm_eps),
                                    (cl["enc_k"][i], cl["enc_v"][i]), cfg)
        x = x + L.gelu_mlp(lp["mlp"], _ln(lp["ln2"], x, cfg.norm_eps))
    return _logits(params, x, cfg), cache
