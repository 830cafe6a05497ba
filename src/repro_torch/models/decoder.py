"""Decoder-only transformer, dense family (llama / granite / qwen /
deepseek), as the reference's ``models/decoder.py``.

Params are one name -> tensor dict whose layer leaves are stacked along
a leading L axis under the reference's names (``layers.attn.wq.w`` is
``(L, d_model, H, hd)``, ``layers.ln1`` is ``(L, d_model)``), so the
compression sees the same leaves as the reference: one pruning threshold
per stacked leaf, and stacked norm scales count as matrices. The
reference's ``lax.scan`` over layers is a Python loop over L here; its
``remat`` (a memory choice with no numerics) and its sharding hints (one
card, no mesh) are left out. MoE and VLM raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.core.scenario import resolve_device
from repro_torch.models import layers as L

LAYER = "layers."


def _check_family(cfg) -> None:
    if cfg.family == "moe":
        raise NotImplementedError("the MoE family is not ported yet: ROADMAP "
                                  "queue 1 item 11 (models/moe.py)")
    if cfg.family == "vlm":
        raise NotImplementedError("the VLM family is not ported yet: ROADMAP "
                                  "queue 1 item 12 (VLM projector)")
    if cfg.family != "dense":
        raise ValueError(f"models/decoder.py runs the dense family, not "
                         f"{cfg.family!r}")


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ------------------------------------------------------------------- init

def init(key, cfg, device=None) -> dict:
    """Random params from ``key`` (an int seed, or a ``torch.Generator``
    whose device the params land on), drawn on the device."""
    _check_family(cfg)
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(
            int(key))
    params = {
        "embed": L.init_embed(gen, cfg.vocab_size, cfg.d_model),
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head.w"] = L.init_dense(gen, cfg.d_model, cfg.vocab_size,
                                           scale=0.02)["w"]

    def one_layer():
        ones = torch.ones((cfg.d_model,), dtype=torch.float32,
                          device=gen.device)
        lp = {"ln1": ones, "ln2": ones.clone()}
        lp.update({"attn." + k: v for k, v in L.init_attn(gen, cfg).items()})
        lp.update({"mlp." + k: v for k, v in L.init_swiglu(
            gen, cfg.d_model, cfg.d_ff, cfg.num_layers).items()})
        return lp

    stacked = L.stack_layers(cfg.num_layers, one_layer)
    params.update({LAYER + k: v for k, v in stacked.items()})
    return dict(sorted(params.items()))      # the reference's flatten order


def _layers(params: dict, cfg) -> list[dict]:
    """Per-layer views ``{"ln1", "ln2", "attn": {...}, "mlp": {...}}`` of
    the stacked leaves (``unbind``, whose backward stacks the per-layer
    gradients back into the stacked leaf)."""
    per = [{"attn": {}, "mlp": {}} for _ in range(cfg.num_layers)]
    for name, leaf in params.items():
        if not name.startswith(LAYER):
            continue
        head, _, rest = name[len(LAYER):].partition(".")
        for lp, x in zip(per, leaf.unbind(0)):
            if rest:
                lp[head][rest] = x
            else:
                lp[head] = x
    return per


# ----------------------------------------------------------------- blocks

def _ffn(lp, x, cfg):
    return x + L.swiglu(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps))


def _block(lp, x, cfg, window):
    h = L.attn_forward(lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                       cfg, window=window)
    return _ffn(lp, x + h, cfg)


def _unembed(params, x, cfg):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return L.unembed(x, params["embed"])
    return L.proj(params, "lm_head", x.to(torch.float32))


# ---------------------------------------------------------------- forward

def forward(params: dict, tokens: torch.Tensor, cfg, *, window: int = 0):
    """Returns (logits (B, T, V) f32, aux_loss), aux 0 for dense."""
    _check_family(cfg)
    x = L.embed(params["embed"], tokens, compute_dtype(cfg))
    for lp in _layers(params, cfg):
        x = _block(lp, x, cfg, window)
    return _unembed(params, x, cfg), torch.zeros((), dtype=torch.float32,
                                                 device=x.device)


def loss_fn(params: dict, batch: dict, cfg) -> torch.Tensor:
    """batch: {"tokens": (B, T+1)}; mean next-token NLL."""
    tokens = batch["tokens"]
    logits, aux = forward(params, tokens[:, :-1], cfg)
    return L.cross_entropy(logits, tokens[:, 1:]) + aux


# ---------------------------------------------------------------- prefill

def prefill(params: dict, tokens: torch.Tensor, cfg, *, window: int = 0):
    """Full-sequence forward that also fills the KV cache. Returns
    (last-token logits (B, 1, V), cache). Always the chunked attention,
    whatever ``cfg.use_flash`` says, as in the reference."""
    _check_family(cfg)
    x = L.embed(params["embed"], tokens, compute_dtype(cfg))
    b, t = x.shape[0], x.shape[1]
    pos = torch.arange(t, device=x.device)
    ks, vs = [], []
    for lp in _layers(params, cfg):
        h_in = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = L.rope(L.proj(lp["attn"], "wq", h_in), pos, cfg.rope_theta)
        k = L.rope(L.proj(lp["attn"], "wk", h_in), pos, cfg.rope_theta)
        v = L.proj(lp["attn"], "wv", h_in)
        o = L.chunked_attention(q, k, v, causal=True, window=window)
        x = _ffn(lp, x + L.proj(lp["attn"], "wo", o.reshape(b, t, -1)), cfg)
        ks.append(k)
        vs.append(v)
    cache = {"layers": {
        "k": torch.stack(ks), "v": torch.stack(vs),
        "slot_pos": torch.arange(t, dtype=torch.int32, device=x.device)
        .expand(cfg.num_layers, t).contiguous()}}
    return _unembed(params, x[:, -1:, :], cfg), cache


# ----------------------------------------------------------------- decode

def init_cache(cfg, batch: int, cache_len: int, device=None) -> dict:
    device = resolve_device(device)
    kv = L.init_kv_cache(batch, cache_len, cfg.num_kv_heads, cfg.head_dim,
                         compute_dtype(cfg), device)
    return {"layers": {
        "k": kv["k"].expand(cfg.num_layers, *kv["k"].shape).contiguous(),
        "v": kv["v"].expand(cfg.num_layers, *kv["v"].shape).contiguous(),
        "slot_pos": kv["slot_pos"].expand(cfg.num_layers, cache_len)
        .contiguous()}}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                cfg):
    """One decode step. tokens: (B, 1); pos: int (shared across the
    batch). Writes the cache in place and returns (logits (B, 1, V),
    cache). A sliding window needs no mask here: the ring of
    ``cache_len`` slots keeps only the newest positions."""
    _check_family(cfg)
    x = L.embed(params["embed"], tokens, compute_dtype(cfg))
    c = cache["layers"]
    for i, lp in enumerate(_layers(params, cfg)):
        cl = {"k": c["k"][i], "v": c["v"][i], "slot_pos": c["slot_pos"][i]}
        h, _ = L.attn_decode(lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                             cl, int(pos), cfg)
        x = _ffn(lp, x + h, cfg)
    return _unembed(params, x, cfg), cache
