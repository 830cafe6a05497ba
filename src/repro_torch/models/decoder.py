"""Decoder-only transformer, as the reference's ``models/decoder.py``:
dense (llama / granite / qwen / deepseek), MoE (granite-moe, qwen3-moe)
and VLM (llava: stub patch embeddings, projected and prepended to the
text tokens).

Params are one name -> tensor dict whose layer leaves are stacked along
a leading L axis under the reference's names (``layers.attn.wq.w`` is
``(L, d_model, H, hd)``, ``layers.ln1`` is ``(L, d_model)``,
``layers.moe.we_g`` is ``(L, E, d_model, d_ff)``), so the compression
sees the same leaves as the reference: one pruning threshold per stacked
leaf, and stacked norm scales count as matrices. The reference's
``lax.scan`` over layers is a Python loop over L here; its ``remat`` (a
memory choice with no numerics) and its sharding hints (one card, no
mesh) are left out. ``num_groups`` (the data shards a MoE layer groups
its tokens by) is threaded wherever the reference threads it.
"""
from __future__ import annotations

import torch

from repro_torch.core.scenario import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.moe import init_moe, moe_apply

LAYER = "layers."


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ------------------------------------------------------------------- init

def make_generator(key, device=None) -> torch.Generator:
    """``key`` itself if it is a ``torch.Generator`` (the params land on
    its device), else a generator seeded with the int ``key`` on
    ``device`` (default ``cuda``)."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(key))


def init(key, cfg, device=None) -> dict:
    """Random params from ``key`` (an int seed, or a ``torch.Generator``
    whose device the params land on), drawn on the device."""
    gen = make_generator(key, device)
    params = {
        "embed": L.init_embed(gen, cfg.vocab_size, cfg.d_model),
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head.w"] = L.init_dense(gen, cfg.d_model, cfg.vocab_size,
                                           scale=0.02)["w"]
    if cfg.family == "vlm":
        params["projector.w"] = L.init_dense(gen, cfg.d_model,
                                             cfg.d_model)["w"]

    def one_layer():
        ones = torch.ones((cfg.d_model,), dtype=torch.float32,
                          device=gen.device)
        lp = {"ln1": ones, "ln2": ones.clone()}
        lp.update({"attn." + k: v for k, v in L.init_attn(gen, cfg).items()})
        if cfg.is_moe:
            lp.update({"moe." + k: v for k, v in init_moe(gen, cfg).items()})
        else:
            lp.update({"mlp." + k: v for k, v in L.init_swiglu(
                gen, cfg.d_model, cfg.d_ff, cfg.num_layers).items()})
        return lp

    stacked = L.stack_layers(cfg.num_layers, one_layer)
    params.update({LAYER + k: v for k, v in stacked.items()})
    return dict(sorted(params.items()))      # the reference's flatten order


def _layers(params: dict) -> list[dict]:
    """Per-layer views ``{"ln1", "ln2", "attn": {...}, "mlp" or "moe":
    {...}}`` of the stacked leaves (``unbind``, whose backward stacks the
    per-layer gradients back into the stacked leaf)."""
    return [L.nest(lp) for lp in L.unstack(L.subtree(params, LAYER))]


# ----------------------------------------------------------------- blocks

def _ffn(lp, x, cfg, num_groups):
    """(x + the FFN's output, the MoE aux loss or None for dense)."""
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.is_moe:
        y, aux = moe_apply(lp["moe"], h, cfg, num_groups)
        return x + y, aux
    return x + L.swiglu(lp["mlp"], h), None


def _block(lp, x, cfg, window, num_groups):
    h = L.attn_forward(lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                       cfg, window=window)
    return _ffn(lp, x + h, cfg, num_groups)


def _embed_inputs(params, tokens, cfg, patches):
    """Text embeddings, with the projected patches in front for VLM."""
    x = L.embed(params["embed"], tokens, compute_dtype(cfg))
    if patches is not None:
        pe = L.proj(params, "projector", patches.to(x.dtype))
        x = torch.cat([pe, x], dim=1)
    return x


def _unembed(params, x, cfg):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return L.unembed(x, params["embed"])
    return L.proj(params, "lm_head", x.to(torch.float32))


# ---------------------------------------------------------------- forward

def forward(params: dict, tokens: torch.Tensor, cfg, *, patches=None,
            window: int = 0, num_groups: int = 1):
    """Returns (logits (B, P + T, V) f32, aux_loss): the MoE layers' aux
    losses summed in layer order, 0 for dense and VLM."""
    x = _embed_inputs(params, tokens, cfg, patches)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _layers(params):
        x, a = _block(lp, x, cfg, window, num_groups)
        if a is not None:
            aux = aux + a
    return _unembed(params, x, cfg), aux


def loss_fn(params: dict, batch: dict, cfg, *, num_groups: int = 1):
    """batch: {"tokens": (B, T+1)} (+ "patches" (B, P, D) for VLM); mean
    next-token NLL plus the aux loss. For VLM ``tokens`` covers only the
    text, and the patch positions carry no loss. As in the reference,
    the forward here groups a MoE layer's tokens by ``GROUP`` alone:
    ``num_groups`` is taken and not passed on."""
    tokens = batch["tokens"]
    patches = batch.get("patches")
    logits, aux = forward(params, tokens[:, :-1], cfg, patches=patches)
    if patches is not None:
        logits = logits[:, patches.shape[1]:, :]
    return L.cross_entropy(logits, tokens[:, 1:]) + aux


# ---------------------------------------------------------------- prefill

def prefill(params: dict, tokens: torch.Tensor, cfg, *, patches=None,
            window: int = 0, num_groups: int = 1):
    """Full-sequence forward that also fills the KV cache, patches (VLM)
    first: the cache covers P + T positions. Returns (last-token logits
    (B, 1, V), cache). Always the chunked attention, whatever
    ``cfg.use_flash`` says, as in the reference."""
    x = _embed_inputs(params, tokens, cfg, patches)
    b, t = x.shape[0], x.shape[1]
    pos = torch.arange(t, device=x.device)
    ks, vs = [], []
    for lp in _layers(params):
        h_in = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = L.rope(L.proj(lp["attn"], "wq", h_in), pos, cfg.rope_theta)
        k = L.rope(L.proj(lp["attn"], "wk", h_in), pos, cfg.rope_theta)
        v = L.proj(lp["attn"], "wv", h_in)
        o = L.chunked_attention(q, k, v, causal=True, window=window)
        x, _ = _ffn(lp, x + L.proj(lp["attn"], "wo", o.reshape(b, t, -1)),
                    cfg, num_groups)
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
                cfg, *, window: int = 0, num_groups: int = 1):
    """One decode step. tokens: (B, 1); pos: int (shared across the
    batch). Writes the cache in place and returns (logits (B, 1, V),
    cache). A sliding window needs no mask here: the ring of
    ``cache_len`` slots keeps only the newest positions, so ``window``
    passes to the attention, which ignores it, as in the reference."""
    x = L.embed(params["embed"], tokens, compute_dtype(cfg))
    c = cache["layers"]
    for i, lp in enumerate(_layers(params)):
        cl = {"k": c["k"][i], "v": c["v"][i], "slot_pos": c["slot_pos"][i]}
        h, _ = L.attn_decode(lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                             cl, int(pos), cfg, window=window)
        x, _ = _ffn(lp, x + h, cfg, num_groups)
    return _unembed(params, x, cfg), cache
