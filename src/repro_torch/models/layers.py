"""Layer building blocks: the MLP's dense layer, and the LM blocks
below. The dense weight layout is the reference's
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
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

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
# blocks of the decoder (models/decoder.py) and of the Whisper
# encoder-decoder (models/whisper.py). Parameters of one block are a flat
# name -> tensor dict ("wq.w", "wq.b", ...); a projection keeps the
# reference's ``w: (d_in, *out_dims)`` layout and attention the
# ``(B, T, H, hd)`` layout. Parameters are stored f32 and cast to the
# compute dtype at use, as in the reference.

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


def decode_attention(q: torch.Tensor, cache: dict, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token attention against the ring cache. q: (B, 1, H, hd).
    Empty slots (slot_pos < 0) are masked; the ring overwrites slots
    older than W, so every written slot is in-window by construction:
    ``window`` is taken and, as in the reference, has no effect."""
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


def attn_forward(p: dict, x: torch.Tensor, cfg, *, window: int = 0,
                 positions: torch.Tensor | None = None, use_rope: bool = True,
                 kv_src: torch.Tensor | None = None,
                 causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (train / prefill); ``kv_src`` given makes it
    cross-attention (k, v from ``kv_src``, never causal). RoPE, when on,
    takes q at ``positions`` (default arange(T)) and k at arange(S).
    ``cfg.use_flash`` routes the attention itself through the
    flash_attention kernel."""
    b, t, _ = x.shape
    src = x if kv_src is None else kv_src
    q = proj(p, "wq", x)                                # (B, T, H, hd)
    k = proj(p, "wk", src)
    v = proj(p, "wv", src)
    if use_rope:
        if positions is None:
            positions = torch.arange(t, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, torch.arange(src.shape[1], device=x.device),
                 cfg.rope_theta)
    attend = (flash_attention if getattr(cfg, "use_flash", False)
              else chunked_attention)
    o = attend(q, k, v, causal=causal and kv_src is None, window=window)
    return proj(p, "wo", o.reshape(b, t, -1))


def attn_decode(p: dict, x: torch.Tensor, cache: dict, pos: int, cfg, *,
                window: int = 0, use_rope: bool = True):
    """Single-step decode. x: (B, 1, D); pos: int. Returns (y, cache).
    ``window`` passes to :func:`decode_attention` (no effect there)."""
    b = x.shape[0]
    q, k = proj(p, "wq", x), proj(p, "wk", x)
    if use_rope:
        ppos = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q = rope(q, ppos, cfg.rope_theta)
        k = rope(k, ppos, cfg.rope_theta)
    cache = kv_cache_update(cache, k, proj(p, "wv", x), pos)
    o = decode_attention(q, cache, window=window)
    return proj(p, "wo", o.reshape(b, 1, -1)), cache


def cross_attn_decode(p: dict, x: torch.Tensor,
                      enc_kv: tuple[torch.Tensor, torch.Tensor],
                      cfg) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V
    (B, S, Hkv, hd): softmax in f32, probabilities cast to v's dtype."""
    b = x.shape[0]
    q = proj(p, "wq", x)
    k, v = enc_kv
    scale = 1.0 / math.sqrt(q.shape[-1])
    n_rep = q.shape[2] // k.shape[2]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, repeat_kv(k, n_rep)) * scale
    pr = torch.softmax(scores.to(torch.float32), dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", pr, repeat_kv(v, n_rep))
    return proj(p, "wo", o.reshape(b, x.shape[1], -1))


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


def init_gelu_mlp(generator: torch.Generator, d_model: int,
                  d_ff: int) -> dict:
    return {**_named("wi.", init_dense(generator, d_model, d_ff, bias=True)),
            **_named("wo.", init_dense(generator, d_ff, d_model, bias=True))}


def gelu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Biased ``wi``, GELU, biased ``wo``. ``jax.nn.gelu`` is the tanh
    approximation by default, and so is this one."""
    return proj(p, "wo", torch.nn.functional.gelu(proj(p, "wi", x),
                                                  approximate="tanh"))


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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token NLL. logits: (B, T, V) f32; labels: (B, T); with
    ``mask`` (B, T) the masked mean ``sum(nll * mask) / max(sum(mask),
    1)``."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    nll = logz - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


# ------------------------------------------------- recurrent building
# blocks of the xLSTM and Mamba2 layers (models/xlstm.py, models/mamba2.py)

def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the reference's ``astype(jnp.float32)`` lands on: f32 for
    f32 and narrower; f64 stays f64, so a float64 run of the port's own
    forms keeps its precision."""
    return torch.promote_types(dtype, torch.float32)


def _conv_taps(windows: torch.Tensor, conv_w: torch.Tensor,
               conv_b: torch.Tensor) -> torch.Tensor:
    """silu(sum_w windows[..., c, w] * conv_w[c, w] + conv_b[c]): the taps
    multiplied and summed in f32 (a bf16 product is exact there), rounded
    once to the input's dtype, then the bias and silu in that dtype, as
    the reference's conv with f32 accumulation."""
    dt = windows.dtype
    acc = acc_dtype(dt)
    w = conv_w.to(dt).to(acc)
    out = (windows.to(acc) * w).sum(-1).to(dt)
    return torch.nn.functional.silu(out + conv_b.to(dt))


def causal_conv(x: torch.Tensor, conv_w: torch.Tensor,
                conv_b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, T, C) with weight (C, W), then
    silu(conv + b). The reference's ``lax.conv_general_dilated`` with
    weight ``w.T[:, None, :]`` and left padding W-1 is a
    cross-correlation: tap w multiplies x[t + w - (W-1)], no flip."""
    width = conv_w.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
    return _conv_taps(xp.unfold(1, width, 1), conv_w, conv_b)


def causal_conv_step(window: torch.Tensor, conv_w: torch.Tensor,
                     conv_b: torch.Tensor) -> torch.Tensor:
    """The decode form of :func:`causal_conv` (the reference's
    ``einsum("bwc,cw->bc")``): window (B, W, C), the last W inputs, the
    newest last -> (B, C)."""
    return _conv_taps(window.transpose(1, 2), conv_w, conv_b)


class _Softplus(torch.autograd.Function):
    """JAX's ``softplus`` = ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)), with logaddexp's custom derivative exp(x - out).
    torch's ``softplus`` is another formula (log1p(exp(x)), the identity
    above x = 20). The values differ from XLA's CPU ones by at most 2
    ulps where they are normal (its exp and log1p are its own)."""

    @staticmethod
    def forward(x):
        return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        inf0 = torch.zeros_like(x)
        return g * torch.exp(torch.where(torch.isposinf(x), inf0, x)
                             - torch.where(torch.isposinf(out), inf0, out))


def softplus(x: torch.Tensor) -> torch.Tensor:
    return _Softplus.apply(x)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


def linspace_f32(start: float, stop: float, n: int, device=None):
    """``jnp.linspace(start, stop, n)`` in f32 by its formula: start *
    (1 - s) + stop * s with s = iota / (n - 1), then stop itself (XLA's
    CPU code rounds some entries an ulp apart)."""
    a = torch.tensor(start, dtype=torch.float32, device=device)
    b = torch.tensor(stop, dtype=torch.float32, device=device)
    if n == 1:
        return a[None]
    step = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    return torch.cat([a * (1 - step) + b * step, b[None]])


def subtree(params: dict, prefix: str) -> dict:
    """The leaves under ``prefix`` (a dotted path ending in "."), named
    from there on."""
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def nest(flat: dict) -> dict:
    """One level of nesting by the first name segment: ``{"ln1": a,
    "attn.wq.w": b}`` -> ``{"ln1": a, "attn": {"wq.w": b}}``."""
    out: dict = {}
    for k, v in flat.items():
        head, _, rest = k.partition(".")
        if rest:
            out.setdefault(head, {})[rest] = v
        else:
            out[head] = v
    return out


def unstack(leaves: dict) -> list[dict]:
    """Per-index views of leaves stacked along a leading axis (``unbind``,
    whose backward stacks the per-index gradients back into the stacked
    leaf)."""
    n = next(iter(leaves.values())).shape[0]
    out = [{} for _ in range(n)]
    for k, v in leaves.items():
        for d, x in zip(out, v.unbind(0)):
            d[k] = x
    return out


def stack_layers(n: int, init_fn) -> dict:
    """``init_fn()`` once per layer, each leaf stacked along a leading L
    axis (the reference's scan layout)."""
    per_layer = [init_fn() for _ in range(n)]
    return {k: torch.stack([lp[k] for lp in per_layer])
            for k in per_layer[0]}


# ------------------------------------------------------------ scans

def _scan_counter():
    """The innermost dispatch mode that counts a scan by its length
    (``launch.analysis.StepCounter``, whose ``repeats_scans`` is set),
    or None. Under it a scan traces two of its steps and scales the
    second's counts by its length - 1: the reference's rule for a
    ``lax.scan``'s length, without dispatching the loop step by step."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if getattr(mode, "repeats_scans", False):
            return mode
    return None


def _call(cell, split, tensors):
    """``cell(consts, carry, x)`` of a flat tensor list split as
    (consts, x, carry)."""
    nc, nx = split
    return cell(tuple(tensors[:nc]), tuple(tensors[nc + nx:]),
                tuple(tensors[nc:nc + nx]))


class _RepeatedStep(torch.autograd.Function):
    """One step of a scan counted for its ``n`` steps 1..N-1, forward and
    backward. The backward recomputes the step uncounted, then counts
    its gradient ``n - 1`` times as a middle step (whose carry the next
    step uses, so it gets a gradient) and once as the last (with the
    gradients the scan's outputs really get). The outputs have the
    step's shapes (not its values past one step: the counter runs on
    fake tensors)."""

    @staticmethod
    def forward(ctx, counter, n, cell, split, *tensors):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*tensors)
        ctx.meta = (counter, n, cell, split)
        with counter.scaled(n):
            carry, y = _call(cell, split, tensors)
        return (*carry, y)

    @staticmethod
    def backward(ctx, *grads):
        counter, n, cell, split = ctx.meta
        needs = ctx.needs_input_grad[4:]
        ins = [t.detach().requires_grad_(r)
               for t, r in zip(ctx.saved_tensors, needs)]
        wrt = [t for t, r in zip(ins, needs) if r]
        with torch.enable_grad(), counter.scaled(0):
            carry, y = _call(cell, split, ins)
            middle = [g if g is not None or not o.requires_grad
                      else torch.zeros_like(o) for o, g in zip(carry, grads)]
        got = [None] * len(wrt)
        for times, gs in ((n - 1, (*middle, grads[-1])), (1, grads)):
            used = [(o, g) for o, g in zip((*carry, y), gs) if g is not None]
            if used and wrt:
                with counter.scaled(times):
                    got = torch.autograd.grad(
                        [o for o, _ in used], wrt, [g for _, g in used],
                        allow_unused=True, retain_graph=True)
        got = iter(got)
        return (None, None, None, None,
                *(next(got) if r else None for r in needs))


def scan(cell, carry: tuple, xs: tuple, consts: tuple = ()):
    """The reference's ``lax.scan`` as a loop from Python:
    ``carry, y_s = cell(consts, carry, x_s)`` for each step s, where
    ``x_s`` holds ``x[:, s]`` of each tensor of ``xs`` (the step axis is
    dim 1). Returns (the final carry, the y_s stacked on dim 1). Tensors
    whose gradient the step needs are passed in ``consts``, ``carry`` or
    ``xs``, not closed over. Under a step counter that repeats scans
    (:func:`_scan_counter`) step 0 runs as itself (its carry may need no
    gradient) and step 1 stands for steps 1..N-1, its counts scaled by
    N - 1: the whole loop's flops, forward and backward."""
    n = xs[0].shape[1]
    counter = _scan_counter()
    if counter is None or n <= 2:
        ys = []
        for s in range(n):
            carry, y = cell(consts, carry, tuple(x[:, s] for x in xs))
            ys.append(y)
        return carry, torch.stack(ys, dim=1)
    carry, first = cell(consts, carry, tuple(x[:, 0] for x in xs))
    out = _RepeatedStep.apply(counter, n - 1, cell, (len(consts), len(xs)),
                              *consts, *(x[:, 1] for x in xs), *carry)
    return tuple(out[:-1]), torch.stack([first] + [out[-1]] * (n - 1), dim=1)
