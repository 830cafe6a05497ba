"""Layer building blocks: the MLP's dense layer, and the LM blocks of
the dense decoder below. The dense weight layout is the reference's
``w: (d_in, d_out)`` (not ``nn.Linear``'s transpose): width slicing cuts
rows = ``d_in`` and cols = ``d_out``, and the aggregation kernels' 2-D
prefix views rely on that layout.

Leading batch axes are allowed on both sides: ``w`` may be
``(..., d_in, d_out)`` with ``b`` ``(..., d_out)`` — one weight set per
client of a cohort, the written-out client axis of the cohort runtime.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention


def init_dense(generator: torch.Generator, d_in: int, d_out, *,
               bias: bool = False, scale: float | None = None,
               device=None) -> dict[str, torch.Tensor]:
    """``{"b", "w"}`` (bias first: the leaf order of the reference's
    sorted-key flatten) with ``w: (d_in, *d_out) ~ N(0, 1) * scale``,
    drawn on the generator's device and moved to ``device`` (default:
    the generator's)."""
    d_out = (d_out,) if isinstance(d_out, int) else tuple(d_out)
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    device = generator.device if device is None else device
    w = torch.randn((d_in, *d_out), generator=generator, dtype=torch.float32,
                    device=generator.device) * scale
    p = {}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=torch.float32, device=device)
    p["w"] = w.to(device)
    return p


def dense(w: torch.Tensor, b: torch.Tensor | None,
          x: torch.Tensor) -> torch.Tensor:
    """x: (..., n, d_in); w: (d_in, d_out) or (..., d_in, d_out)."""
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        b = b.to(x.dtype)
        y = y + (b.unsqueeze(-2) if w.dim() > 2 else b)
    return y


# ------------------------------------------------------------- LM building
# blocks of the dense decoder (models/decoder.py). Parameters of one block
# are a flat name -> tensor dict ("wq.w", "wq.b", ...); a projection keeps
# the reference's ``w: (d_in, *out_dims)`` layout and attention the
# ``(B, T, H, hd)`` layout. Parameters are stored f32 and cast to the
# compute dtype at use, as in the reference. The reference's options that
# only other families use (cross-attention, no RoPE, non-causal) wait for
# those families.

def proj(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """The reference's ``dense`` for an LM leaf: x (..., d_in) @
    w (d_in, *out_dims) -> (..., *out_dims), in x's dtype, plus the bias
    if ``p`` has one."""
    w, b = p[name + ".w"], p.get(name + ".b")
    y = dense(w.reshape(w.shape[0], -1), None if b is None else b.reshape(-1),
              x)
    return y.reshape(*x.shape[:-1], *w.shape[1:])


def _named(prefix: str, p: dict) -> dict:
    return {prefix + k: v for k, v in p.items()}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.to(torch.float32)).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.to(torch.float32) + b.to(torch.float32)).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split convention. x: (..., T, H, hd);
    positions: broadcastable to (..., T)."""
    hd = x.shape[-1]
    half = hd // 2
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                             device=x.device) / half))
    ang = positions.to(torch.float32)[..., None] * inv_freq     # (..., T, half)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)             # (..., T, 1, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, Hkv*n_rep, hd)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _band_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """Memory-bounded attention: a loop over query chunks (scores never
    exceed (B, H, q_chunk, S)). q: (B, T, H, hd); k, v: (B, S, Hkv, hd).
    window > 0 masks keys further than ``window`` behind the query;
    q_offset is the absolute position of q[0] relative to k[0]."""
    b, t, h, hd = q.shape
    s = k.shape[1]
    n_rep = h // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(hd)
    q_chunk = min(q_chunk, t)
    if t % q_chunk:
        q_chunk = t  # fall back: unchunked (small T)
    kp = torch.arange(s, device=q.device)
    out = []
    for qs in range(0, t, q_chunk):
        scores = torch.einsum("bqhd,bkhd->bhqk", q[:, qs:qs + q_chunk],
                              k) * scale
        qpos = q_offset + qs + torch.arange(q_chunk, device=q.device)
        mask = _band_mask(qpos, kp, causal, window)
        scores = scores.to(torch.float32).masked_fill(~mask, -1e30)
        p = torch.softmax(scores, dim=-1).to(v.dtype)
        out.append(torch.einsum("bhqk,bkhd->bqhd", p, v))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


# Decode KV cache: ring buffer of size W (= full seq len when W >= max pos).
# ``slot_pos`` records the absolute position stored in each slot (-1 =
# empty), which makes sliding-window decode exact for positions >= W.

def init_kv_cache(batch: int, cache_len: int, n_kv: int, head_dim: int,
                  dtype, device="cpu") -> dict:
    return {
        "k": torch.zeros((batch, cache_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, cache_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "slot_pos": torch.full((cache_len,), -1, dtype=torch.int32,
                               device=device),
    }


def kv_cache_update(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                    pos: int) -> dict:
    """Insert one step (B, 1, Hkv, hd) at slot pos % W, in place. The
    reference writes the slot with a masked select over the whole cache
    (an elementwise op that partitions across a sharded sequence axis);
    on one card the in-place slot write gives the same values and moves
    only the slot's bytes."""
    slot = pos % cache["k"].shape[1]
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["slot_pos"][slot] = pos
    return cache


def decode_attention(q: torch.Tensor, cache: dict) -> torch.Tensor:
    """Single-token attention against the ring cache. q: (B, 1, H, hd).
    Empty slots (slot_pos < 0) are masked; the ring overwrites slots
    older than W, so every written slot is in-window by construction
    (the reference's ``window`` argument here has no effect)."""
    n_rep = q.shape[2] // cache["k"].shape[2]
    k = repeat_kv(cache["k"], n_rep)
    v = repeat_kv(cache["v"], n_rep)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    valid = cache["slot_pos"] >= 0
    scores = scores.to(torch.float32).masked_fill(
        ~valid[None, None, None, :], -1e30)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def init_attn(generator: torch.Generator, cfg) -> dict:
    hd = cfg.head_dim
    kv = (cfg.num_kv_heads, hd)
    return {
        **_named("wk.", init_dense(generator, cfg.d_model, kv,
                                   bias=cfg.qkv_bias)),
        **_named("wo.", init_dense(
            generator, cfg.num_heads * hd, cfg.d_model,
            scale=1.0 / math.sqrt(cfg.num_heads * hd * 2 * cfg.num_layers))),
        **_named("wq.", init_dense(generator, cfg.d_model,
                                   (cfg.num_heads, hd), bias=cfg.qkv_bias)),
        **_named("wv.", init_dense(generator, cfg.d_model, kv,
                                   bias=cfg.qkv_bias)),
    }


def attn_forward(p: dict, x: torch.Tensor, cfg, *,
                 window: int = 0) -> torch.Tensor:
    """Full-sequence causal self-attention (train). ``cfg.use_flash``
    routes the attention itself through the flash_attention kernel."""
    b, t, _ = x.shape
    pos = torch.arange(t, device=x.device)
    q = rope(proj(p, "wq", x), pos, cfg.rope_theta)      # (B, T, H, hd)
    k = rope(proj(p, "wk", x), pos, cfg.rope_theta)
    v = proj(p, "wv", x)
    if getattr(cfg, "use_flash", False):
        o = flash_attention(q, k, v, causal=True, window=window)
    else:
        o = chunked_attention(q, k, v, causal=True, window=window)
    return proj(p, "wo", o.reshape(b, t, -1))


def attn_decode(p: dict, x: torch.Tensor, cache: dict, pos: int, cfg):
    """Single-step decode. x: (B, 1, D); pos: int. Returns (y, cache)."""
    b = x.shape[0]
    ppos = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = rope(proj(p, "wq", x), ppos, cfg.rope_theta)
    k = rope(proj(p, "wk", x), ppos, cfg.rope_theta)
    cache = kv_cache_update(cache, k, proj(p, "wv", x), pos)
    o = decode_attention(q, cache)
    return proj(p, "wo", o.reshape(b, 1, -1)), cache


def init_swiglu(generator: torch.Generator, d_model: int, d_ff: int,
                num_layers: int = 1) -> dict:
    return {
        **_named("wg.", init_dense(generator, d_model, d_ff)),
        **_named("wi.", init_dense(generator, d_model, d_ff)),
        **_named("wo.", init_dense(generator, d_ff, d_model,
                                   scale=1.0 / math.sqrt(d_ff * 2 * num_layers))),
    }


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    return proj(p, "wo", torch.nn.functional.silu(proj(p, "wg", x))
                * proj(p, "wi", x))


def init_embed(generator: torch.Generator, vocab: int,
               d_model: int) -> torch.Tensor:
    return torch.randn((vocab, d_model), generator=generator,
                       dtype=torch.float32, device=generator.device) * 0.02


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return torch.nn.functional.embedding(tokens.to(torch.int64),
                                         table).to(dtype)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits in f32. table: (V, D) (tied) used transposed."""
    return torch.matmul(x.to(torch.float32), table.to(torch.float32).t())


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL. logits: (B, T, V) f32; labels: (B, T)."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return torch.mean(logz - ll)


def stack_layers(n: int, init_fn) -> dict:
    """``init_fn()`` once per layer, each leaf stacked along a leading L
    axis (the reference's scan layout)."""
    per_layer = [init_fn() for _ in range(n)]
    return {k: torch.stack([lp[k] for lp in per_layer])
            for k in per_layer[0]}
