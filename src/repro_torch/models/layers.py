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
from collections.abc import Mapping

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import parallel
from repro_torch.models.sharding import cache_model_dim, slot_range


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


def proj_whole(p: dict, name: str, x: torch.Tensor, full: int,
               x_model: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`proj` with a 2-D leaf whose ``full`` output columns may be
    split over "model" in blocks that do not line up with the output's
    parts (the reference lets GSPMD reshard them): this rank's columns of
    ``x`` (replicated, entering through ``copy_to_model``; ``x_model`` is
    that copy when several projections of ``x`` share it), gathered
    whole. The caller uses the whole output alike on every rank, or
    takes its own part through ``split_to_model`` / ``copy_to_model``,
    so the gradient of the whole is whole on every rank and
    ``gather_from_model`` keeps this rank's block of it."""
    if p[name + ".w"].shape[-1] == full:
        return proj(p, name, x)
    if x_model is None:
        x_model = parallel.copy_to_model(x)
    return parallel.gather_from_model(proj(p, name, x_model), -1)


def _named(prefix: str, p: dict) -> dict:
    return {prefix + k: v for k, v in p.items()}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.to(torch.float32)).to(dt)


def norm_proj_rows(p: dict, name: str, y: torch.Tensor,
                   norm_w: torch.Tensor, full: int, eps: float,
                   gate=None) -> torch.Tensor:
    """The tail of a layer: :func:`rms_norm` of ``y`` (width ``full``) by
    ``norm_w``, then ``gate(h, local)`` where given, then the projection
    ``name`` (a 2-D leaf). On a mesh of several ranks ``norm_w`` and
    ``name``'s rows may be this rank's block of ``full``, split over
    "model" (Mamba's ``gate_norm`` / ``out_proj``, mLSTM's ``mnorm`` /
    ``down``, sLSTM's ``gnorm`` / ``down``): ``local(t)`` is then this
    rank's block of a whole ``t`` (``y`` may already be the block: its
    heads), the sum of squares of each row is all-reduced over "model" (a
    (..., 1) f32 tensor crosses the ranks, not the rows) with its
    gradient summed, and the partial outputs are summed over "model"."""
    width = norm_w.shape[-1]

    def local(t: torch.Tensor) -> torch.Tensor:
        return t if t.shape[-1] == width else parallel.split_to_model(t, -1)

    if width == full:
        h = rms_norm(y, norm_w, eps)
    else:
        dt = y.dtype
        x = local(y).to(torch.float32)
        ss = parallel.copy_to_model(parallel.reduce_from_model(
            torch.sum(x * x, dim=-1, keepdim=True)))
        h = (x * torch.rsqrt(ss / full + eps)
             * norm_w.to(torch.float32)).to(dt)
    if gate is not None:
        h = gate(h, local)
    out = proj(p, name, h)
    return out if width == full else parallel.reduce_from_model(out)


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


def _model_block(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (whole) cut to this rank's block over "model" along each dim
    past the first two where ``like`` (a block of the same leaf) is
    smaller: a cache block's kv heads or head_dim. ``t`` itself where
    none is."""
    for d in range(2, t.dim()):
        if like.shape[d] != t.shape[d]:
            t = parallel.block(t, "model", d)
    return t


def kv_cache_update(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                    pos: int) -> dict:
    """Insert one step (B, 1, Hkv, hd) at slot pos % W, in place. The
    reference writes the slot with a masked select over the whole cache
    (an elementwise op that partitions across a sharded sequence axis);
    on one card the in-place slot write gives the same values and moves
    only the slot's bytes. On a mesh of several ranks ``cache`` is this
    rank's block, as ``sharding.cache_spec_tree`` places it, and
    ``k_new`` / ``v_new`` are whole: where the block is a block of the
    slots (the sequence axis on "model") the rank that holds the slot
    writes it, where it is a block of the kv heads or of head_dim every
    rank writes its block of the step; ``slot_pos`` (whole on every rank)
    is written everywhere."""
    n = cache["slot_pos"].shape[0]
    slot = pos % n
    lo, hi = slot_range(cache["k"].shape[1], n)
    if lo <= slot < hi:
        cache["k"][:, slot - lo] = _model_block(
            k_new, cache["k"])[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot - lo] = _model_block(
            v_new, cache["v"])[:, 0].to(cache["v"].dtype)
    cache["slot_pos"][slot] = pos
    return cache


def decode_attention(q: torch.Tensor, cache: dict, *, window: int = 0,
                     kv_heads: int | None = None) -> torch.Tensor:
    """Single-token attention against the ring cache. q: (B, 1, H, hd).
    Empty slots (slot_pos < 0) are masked; the ring overwrites slots
    older than W, so every written slot is in-window by construction:
    ``window`` is taken and, as in the reference, has no effect. On a
    mesh of several ranks ``cache`` is this rank's block of a cache of
    ``kv_heads`` kv heads (default: the block's own), as
    ``sharding.cache_spec_tree`` places it, and q is whole
    (:func:`_attend_blocks`)."""
    n = cache["slot_pos"].shape[0]
    lo, hi = slot_range(cache["k"].shape[1], n)
    return _attend_blocks(q, cache["k"], cache["v"],
                          cache["slot_pos"][lo:hi] >= 0, n,
                          kv_heads or cache["k"].shape[2])


def _attend_blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid: torch.Tensor | None, n_slots: int,
                   kv_heads: int) -> torch.Tensor:
    """One query step's attention on a mesh of several ranks, against
    this rank's block of a cache of ``n_slots`` slots and ``kv_heads``
    kv heads (``sharding.cache_spec_tree``'s rule: the slots over
    "model", else the kv heads, else head_dim; or whole). q: (B, 1, H,
    hd) whole; k, v: the block (B, S', Hkv', hd'); ``valid``: which of
    the block's slots are written (None: all). Returns the output (B, 1,
    H, hd) whole on every rank; off a mesh of ranks the plain attention
    with the softmax in f32, probabilities cast to v's dtype.

    - Slots: flash-decoding. Each rank scores every head against its
      slots; the softmax takes the max and the sum of exponentials over
      the ranks (``parallel.softmax_over``), and the ranks' partial
      ``p @ v`` are summed (``parallel.sum_over``).
    - kv heads: each rank runs the q heads that read its kv heads, a
      whole softmax, and the heads' outputs are gathered.
    - head_dim: each rank's partial dot products over its block of
      head_dim are summed into the whole scores, and the outputs' blocks
      of head_dim gathered."""
    hd = q.shape[-1]
    rep = q.shape[2] // kv_heads
    split = parallel.group("model") is not None
    heads = split and k.shape[2] != kv_heads
    dims = split and k.shape[3] != hd
    if heads:                   # the q heads of this rank's kv heads
        hl = k.shape[2] * rep
        q = q.narrow(2, parallel.rank("model") * hl, hl)
    elif dims:
        q = q.narrow(3, parallel.rank("model") * k.shape[3], k.shape[3])
    k, v = repeat_kv(k, rep), repeat_kv(v, rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if dims:
        scores = parallel.sum_over(scores, "model")
    scores = (scores * (1.0 / math.sqrt(hd))).to(torch.float32)
    if valid is not None:
        scores = scores.masked_fill(~valid[None, None, None, :], -1e30)
    slots = split and k.shape[1] != n_slots
    p = (parallel.softmax_over(scores, "model") if slots
         else torch.softmax(scores, dim=-1)).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    if slots:
        return parallel.sum_over(o, "model")
    if heads or dims:
        return parallel.gather_from_model(o, -2 if heads else -1)
    return o


def cache_block(x: torch.Tensor, name: str, whole=None) -> torch.Tensor:
    """This rank's block over "model" of the cache leaf ``name`` (one
    layer's, or stacked; its batch rows already this rank's): the dim
    that ``sharding.cache_spec_tree``'s rule puts on "model" for the
    leaf's ``whole`` shape (default: ``x``'s own), cut where ``x`` is
    whole along it, and ``x`` itself where it already holds a block (a
    recurrent state computed on this rank's heads), on one rank, or
    where the rule splits nothing. The block is a tensor of its own."""
    if parallel.group("model") is None:
        return x
    whole = tuple(x.shape) if whole is None else tuple(whole)
    m = parallel.size("model")
    dim = cache_model_dim(name, whole, m)
    if dim is None or x.shape[dim] != whole[dim]:
        return x
    n = x.shape[dim] // m
    # a copy of its own: a view would keep the whole leaf alive (a block of
    # the slots of one row is contiguous, so .contiguous() would not copy)
    return x.narrow(dim, parallel.rank("model") * n, n).clone(
        memory_format=torch.contiguous_format)


def cache_whole(x: torch.Tensor, dim: int, full: int) -> torch.Tensor:
    """A cache leaf's block ``x`` gathered whole along ``dim`` (of size
    ``full`` whole) where it is a block there, ``x`` itself elsewhere: a
    recurrent state that a decode step runs whole where its heads do not
    split (the rule's fallback dim), kept as the block between steps."""
    if x.shape[dim] == full:
        return x
    return parallel.all_gather(x, "model", dim)


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


HEADS, HEAD_DIM = "heads", "head_dim"


def _qkv_layout(w: torch.Tensor, heads: int, cfg):
    """Which dim of a q / k / v leaf (d_model, heads, hd) ``w`` holds a
    block of over "model": HEADS, HEAD_DIM, D_MODEL, or None (whole)."""
    if w.shape[-2] != heads:
        return HEADS
    if w.shape[-1] != cfg.head_dim:
        return HEAD_DIM
    if w.shape[-3] != cfg.d_model:
        return D_MODEL
    return None


def _with_bias(p: dict, name: str, y: torch.Tensor) -> torch.Tensor:
    b = p.get(name + ".b")
    return y if b is None else y + b.to(y.dtype)


def _kv_heads(k: torch.Tensor, h0: int, hl: int, rep: int) -> torch.Tensor:
    """The kv heads (dim 2 of the whole ``k``) that q heads [h0, h0 + hl)
    read at the GQA ratio ``rep``, at a local ratio that maps each local
    q head to its own kv head; each q head's own copy where no such
    slice exists. Contiguous, as the flash kernel takes it."""
    lo, hi = h0 // rep, (h0 + hl - 1) // rep + 1
    if hl % (hi - lo) == 0 and all(
            (h0 + j) // rep == lo + j // (hl // (hi - lo))
            for j in range(hl)):
        return k[:, :, lo:hi].contiguous()
    return repeat_kv(k, rep)[:, :, h0:h0 + hl].contiguous()


def attn_forward(p: dict, x: torch.Tensor, cfg, *, window: int = 0,
                 positions: torch.Tensor | None = None, use_rope: bool = True,
                 kv_src: torch.Tensor | None = None,
                 causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (train / prefill); ``kv_src`` given makes it
    cross-attention (k, v from ``kv_src``, never causal). RoPE, when on,
    takes q at ``positions`` (default arange(T)) and k at arange(S).
    ``cfg.use_flash`` routes the attention itself through the
    flash_attention kernel.

    Under a mesh whose "model" axis splits the leaves, each of q / k / v
    is found from its leaf's shape split on its heads, else head_dim,
    else d_model (:func:`_qkv_layout`, the reference's rule order). A
    head or head_dim block is a column block of the projection (its input
    enters through ``copy_to_model``); a head_dim block is gathered whole
    before RoPE, which pairs the two halves of head_dim. A d_model block
    takes this rank's block of the input (``split_to_model``), and its
    partial q / k / v are summed by ``reduce_from_model``. Where q is
    split on heads, each rank attends with its q heads over the kv heads
    they read (a whole k / v sliced per rank takes the ranks' summed
    gradient, ``copy_to_model``), and ``wo``'s rows of those heads give a
    partial output, summed. Where no head split is left, every rank
    attends with every head: correct, only slower; ``wo`` then takes
    this rank's rows of the output (its rows split) or gives a block of
    its columns, gathered whole."""
    b, t, _ = x.shape
    src = x if kv_src is None else kv_src
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    lay = {n: _qkv_layout(p[n + ".w"], h if n == "wq" else hkv, cfg)
           for n in ("wq", "wk", "wv")}
    forms = {}                  # each input's split forms, made once

    def form(inp, kind):
        key = (id(inp), kind == D_MODEL)
        if key not in forms:
            forms[key] = (parallel.split_to_model(inp, -1) if kind == D_MODEL
                          else parallel.copy_to_model(inp))
        return forms[key]

    local = lay["wq"] == HEADS   # each rank attends with its own q heads

    def project(name, inp):
        kind = lay[name]
        if kind is None:
            y = proj(p, name, inp)                      # (B, T, H, hd)
        elif kind == D_MODEL:    # this rank's rows: a partial sum
            w = p[name + ".w"]
            y = dense(w.reshape(w.shape[0], -1), None, form(inp, kind))
            y = parallel.reduce_from_model(y).reshape(*inp.shape[:-1],
                                                      *w.shape[1:])
            y = _with_bias(p, name, y)
        else:
            y = proj(p, name, form(inp, kind))
            if kind == HEAD_DIM:
                return (parallel.gather_to_ranks(y, -1) if local
                        else parallel.gather_from_model(y, -1))
        return parallel.copy_to_model(y) if local and kind != HEADS else y

    q, k, v = project("wq", x), project("wk", src), project("wv", src)
    if local and lay["wk"] != HEADS:
        hl = q.shape[2]
        h0 = parallel.rank("model") * hl
        k, v = (_kv_heads(t_, h0, hl, h // hkv) for t_ in (k, v))
    if use_rope:
        if positions is None:
            positions = torch.arange(t, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, torch.arange(src.shape[1], device=x.device),
                 cfg.rope_theta)
    attend = (flash_attention if getattr(cfg, "use_flash", False)
              else chunked_attention)
    o = attend(q, k, v, causal=causal and kv_src is None, window=window)
    return _attn_out(p, o.reshape(b, t, -1), cfg, local)


def _attn_out(p: dict, o: torch.Tensor, cfg, local: bool) -> torch.Tensor:
    """``wo`` of the attention's output ``o`` (..., H * hd): ``local``,
    ``o`` holds this rank's q heads, else every head. ``wo``'s rows may
    be this rank's block (a partial output, summed), its columns a block
    (gathered whole), or it is whole."""
    wo = p["wo.w"]
    wo_rows = wo.shape[-2] != cfg.num_heads * cfg.head_dim
    wo_cols = wo.shape[-1] != cfg.d_model
    if local and not wo_rows:    # wo whole or on d_model: every head
        o, local = parallel.gather_from_model(o, -1), False
    if wo_rows:                  # this rank's rows: a partial output
        if not local:
            o = parallel.split_to_model(o, -1)
        y = parallel.reduce_from_model(dense(wo, None, o))
    elif wo_cols:                # a block of the output's columns
        y = parallel.gather_from_model(
            dense(wo, None, parallel.copy_to_model(o)), -1)
    else:
        y = dense(wo, None, o)
    return _with_bias(p, "wo", y)


def qkv_whole(p: dict, name: str, x: torch.Tensor, heads: int,
               cfg) -> torch.Tensor:
    """The projection ``name`` (q, k or v: ``heads`` heads) of ``x``
    (replicated over "model"), whole on every rank, whatever block of
    its leaf this rank holds (:func:`_qkv_layout`): a block of the heads
    or of head_dim is gathered, a block of d_model's partial sums summed.
    No gradient is taken (prefill and decode)."""
    w = p[name + ".w"]
    kind = _qkv_layout(w, heads, cfg)
    if kind is None:
        return proj(p, name, x)
    if kind == D_MODEL:
        y = dense(w.reshape(w.shape[0], -1), None,
                  parallel.split_to_model(x, -1))
        y = parallel.reduce_from_model(y).reshape(*x.shape[:-1],
                                                  *w.shape[1:])
        return _with_bias(p, name, y)
    return parallel.gather_from_model(proj(p, name, x),
                                      -2 if kind == HEADS else -1)


def attn_prefill(p: dict, x: torch.Tensor, cfg, *, window: int = 0,
                 positions: torch.Tensor | None = None,
                 use_rope: bool = True):
    """A prefill's causal self-attention over x (B, T, D): (y, k, v),
    where k and v (B, T, Hkv, hd) are whole for the cache (RoPE, when on,
    at ``positions``, default arange(T)). Always the chunked attention,
    as in the reference. On a mesh of several ranks each rank holds its
    blocks of the leaves and k and v are whole on every rank (the caller
    keeps its block, :func:`cache_block`): where q's leaf is split on its
    heads each rank attends with its own q heads over the kv heads they
    read, and ``wo``'s rows of those heads give a partial output, summed;
    otherwise q is whole and each rank attends with its block of the
    query rows (:func:`_attend_rows`)."""
    b, t, _ = x.shape
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    local = _qkv_layout(p["wq.w"], h, cfg) == HEADS
    if use_rope and positions is None:
        positions = torch.arange(t, device=x.device)

    def rot(y):
        return rope(y, positions, cfg.rope_theta) if use_rope else y

    q = rot(proj(p, "wq", x) if local else qkv_whole(p, "wq", x, h, cfg))
    k = rot(qkv_whole(p, "wk", x, hkv, cfg))
    v = qkv_whole(p, "wv", x, hkv, cfg)
    if local:
        hl = q.shape[2]
        h0 = parallel.rank("model") * hl
        kq, vq = (_kv_heads(t_, h0, hl, h // hkv) for t_ in (k, v))
        o = chunked_attention(q, kq, vq, causal=True, window=window)
    else:
        o = _attend_rows(q, k, v, window)
    return _attn_out(p, o.reshape(b, t, -1), cfg, local), k, v


def _attend_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int) -> torch.Tensor:
    """The prefill's causal chunked attention of the whole q (B, T, H, hd)
    over the whole k and v, split over "model" by query rows: rank r
    attends with rows [r n, r n + n), n = ceil(T / M) (the last block
    short, or empty), at their own positions (``q_offset``); the blocks,
    the short one padded to n rows, are gathered and cut to T. Each row's
    attention is the one-rank row's: where n is a multiple of the chunk
    the rank's chunks are the one-rank run's. The plain attention off a
    mesh of ranks."""
    if parallel.group("model") is None:
        return chunked_attention(q, k, v, causal=True, window=window)
    b, t, h, _ = q.shape
    n = -(-t // parallel.size("model"))
    lo = min(parallel.rank("model") * n, t)
    rows = min(n, t - lo)
    o = (chunked_attention(q.narrow(1, lo, rows), k, v, causal=True,
                           window=window, q_offset=lo) if rows
         else v.new_zeros((b, 0, h, v.shape[-1])))
    if rows < n:
        o = torch.cat([o, o.new_zeros((b, n - rows, *o.shape[2:]))], 1)
    return parallel.gather_from_model(o, 1)[:, :t]


def attn_decode(p: dict, x: torch.Tensor, cache: dict, pos: int, cfg, *,
                window: int = 0, use_rope: bool = True):
    """Single-step decode. x: (B, 1, D); pos: int. Returns (y, cache).
    ``window`` passes to :func:`decode_attention` (no effect there).

    On a mesh of several ranks ``cache`` is this rank's block
    (``sharding.cache_spec_tree``) and the leaves its blocks: q, k and v
    are made whole on every rank (their blocks gathered, or their
    partial sums over d_model summed), the step's k and v written into
    the block (:func:`kv_cache_update`), the attention run against it
    and ``wo`` takes the whole output."""
    b = x.shape[0]
    q = qkv_whole(p, "wq", x, cfg.num_heads, cfg)
    k = qkv_whole(p, "wk", x, cfg.num_kv_heads, cfg)
    if use_rope:
        ppos = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q = rope(q, ppos, cfg.rope_theta)
        k = rope(k, ppos, cfg.rope_theta)
    cache = kv_cache_update(cache, k, qkv_whole(
        p, "wv", x, cfg.num_kv_heads, cfg), pos)
    o = decode_attention(q, cache, window=window, kv_heads=cfg.num_kv_heads)
    return _attn_out(p, o.reshape(b, 1, -1), cfg, False), cache


def cross_attn_decode(p: dict, x: torch.Tensor,
                      enc_kv: tuple[torch.Tensor, torch.Tensor],
                      cfg) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V
    (B, S, Hkv, hd): softmax in f32, probabilities cast to v's dtype. On
    a mesh of several ranks ``enc_kv`` is this rank's block of the cache's
    cross-KV (its ``encoder_seq`` rows, kv heads or head_dim over "model",
    as ``sharding.cache_spec_tree`` places it): :func:`_attend_blocks`,
    unmasked."""
    k, v = enc_kv
    q = qkv_whole(p, "wq", x, cfg.num_heads, cfg)
    o = _attend_blocks(q, k, v, None, cfg.encoder_seq, cfg.num_kv_heads)
    return _attn_out(p, o.reshape(x.shape[0], x.shape[1], -1), cfg, False)


def init_swiglu(generator: torch.Generator, d_model: int, d_ff: int,
                num_layers: int = 1) -> dict:
    return {
        **_named("wg.", init_dense(generator, d_model, d_ff)),
        **_named("wi.", init_dense(generator, d_model, d_ff)),
        **_named("wo.", init_dense(generator, d_ff, d_model,
                                   scale=1.0 / math.sqrt(d_ff * 2 * num_layers))),
    }


def swiglu(p: dict, x: torch.Tensor, *, split: bool = False) -> torch.Tensor:
    """``split``: ``p`` holds this rank's columns of ``wi`` / ``wg`` and
    rows of ``wo`` (d_ff split over "model"): the input enters through
    ``copy_to_model`` and the output is summed by ``reduce_from_model``."""
    if split:
        x = parallel.copy_to_model(x)
    y = proj(p, "wo", torch.nn.functional.silu(proj(p, "wg", x))
             * proj(p, "wi", x))
    return parallel.reduce_from_model(y) if split else y


def init_gelu_mlp(generator: torch.Generator, d_model: int,
                  d_ff: int) -> dict:
    return {**_named("wi.", init_dense(generator, d_model, d_ff, bias=True)),
            **_named("wo.", init_dense(generator, d_ff, d_model, bias=True))}


def gelu_mlp(p: dict, x: torch.Tensor, *,
             split: bool = False) -> torch.Tensor:
    """Biased ``wi``, GELU, biased ``wo``. ``jax.nn.gelu`` is the tanh
    approximation by default, and so is this one. ``split``: ``p`` holds
    this rank's columns of ``wi`` and ``wi.b`` and rows of ``wo`` (d_ff
    split over "model"): the input enters through ``copy_to_model``, the
    partial outputs are summed by ``reduce_from_model`` and ``wo.b`` is
    added once, after the sum."""
    if not split:
        return proj(p, "wo", torch.nn.functional.gelu(proj(p, "wi", x),
                                                      approximate="tanh"))
    h = torch.nn.functional.gelu(proj(p, "wi", parallel.copy_to_model(x)),
                                 approximate="tanh")
    return _with_bias(p, "wo", parallel.reduce_from_model(
        dense(p["wo.w"], None, h)))


def init_embed(generator: torch.Generator, vocab: int,
               d_model: int) -> torch.Tensor:
    return torch.randn((vocab, d_model), generator=generator,
                       dtype=torch.float32, device=generator.device) * 0.02


# The vocabulary layouts of an embedding table (V, D) or an lm_head
# (D, V) split over "model": VOCAB, each rank a block of the vocabulary;
# D_MODEL, each rank a block of d_model (the fallback for a vocabulary that
# does not divide); None, whole.
VOCAB, D_MODEL = "vocab", "d_model"


def _vocab_block(ids: torch.Tensor, n: int):
    """(ids - this rank's first vocabulary id, clamped into [0, n); which
    ids fall in this rank's block of n)."""
    local = ids.to(torch.int64) - parallel.rank("model") * n
    inside = (local >= 0) & (local < n)
    return torch.where(inside, local, torch.zeros_like(local)), inside


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype,
          layout: str | None = None) -> torch.Tensor:
    """``layout`` VOCAB: ``table`` is this rank's rows; tokens outside
    them give zeros, and the ranks' rows are summed. D_MODEL: this rank's
    columns, gathered whole."""
    if layout == VOCAB:
        local, inside = _vocab_block(tokens, table.shape[0])
        e = torch.nn.functional.embedding(local, table)
        e = torch.where(inside[..., None], e, torch.zeros_like(e))
        return parallel.reduce_from_model(e).to(dtype)
    e = torch.nn.functional.embedding(tokens.to(torch.int64), table)
    if layout == D_MODEL:
        e = parallel.gather_from_model(e, -1)
    return e.to(dtype)


def unembed(x: torch.Tensor, table: torch.Tensor,
            layout: str | None = None) -> torch.Tensor:
    """Logits in f32. table: (V, D) (tied) used transposed. ``layout``
    VOCAB: this rank's block of the logits; D_MODEL: partial logits over
    this rank's columns, summed whole."""
    x = x.to(torch.float32)
    if layout == VOCAB:
        x = parallel.copy_to_model(x)
    elif layout == D_MODEL:
        x = parallel.split_to_model(x, -1)
    y = torch.matmul(x, table.to(torch.float32).t())
    return parallel.reduce_from_model(y) if layout == D_MODEL else y


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None, *,
                  vocab_split: bool = False) -> torch.Tensor:
    """Mean next-token NLL. logits: (B, T, V) f32; labels: (B, T); with
    ``mask`` (B, T) the masked mean ``sum(nll * mask) / max(sum(mask),
    1)``. ``vocab_split``: ``logits`` is this rank's block of the
    vocabulary (``unembed(..., VOCAB)``); the max, the sum of exps and
    the target logit are each all-reduced over "model"."""
    if vocab_split:
        m = parallel.all_reduce(logits.detach().amax(dim=-1), "model",
                                torch.distributed.ReduceOp.MAX)
        se = parallel.reduce_from_model(
            torch.sum(torch.exp(logits - m[..., None]), dim=-1))
        logz = m + torch.log(se)
        local, inside = _vocab_block(labels, logits.shape[-1])
        ll = torch.gather(logits, -1, local[..., None])[..., 0]
        ll = parallel.reduce_from_model(
            torch.where(inside, ll, torch.zeros_like(ll)))
    else:
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1,
                          labels.to(torch.int64)[..., None])[..., 0]
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


class _Wholes:
    """The whole leaves gathered for the views of one params tree, each by
    its block's id: the tree's top's (scope None), kept while the tree
    is and for the backward, and the layer's read last, which a read in
    another scope drops and the backward gathers again."""

    def __init__(self):
        self.scope, self.top, self.layer = None, {}, {}

    def get(self, scope, blk: torch.Tensor, dim: int, axes: tuple):
        if scope != self.scope:
            self.scope, self.layer = scope, {}
        leaves = self.top if scope is None else self.layer
        if id(blk) not in leaves:
            leaves[id(blk)] = parallel.gather_blocks(
                blk, dim, axes, regather=scope is not None)
        return leaves[id(blk)]


class Blocks(Mapping):
    """A params dict of which the leaves named in ``split`` are this rank's
    blocks of FSDP leaves: ``split[name] = (dim, axes)``, the leaf split
    along ``dim`` over the data ``axes`` (``sharding.data_splits``; its
    "model" block, where it has one, stays a block). Reading such a leaf
    gives it whole (``parallel.gather_blocks``), gathered at its first
    read. The scope of a view from :func:`unstack` is its layer: a
    family's loop gathers layer l's leaves when it reaches layer l and
    lets them go at the next read elsewhere; under
    ``parallel.regathering`` the backward gathers them again, so no
    layer is kept whole from the forward to the backward. A leaf outside
    the layer stacks (the embedding, a head, the final norm, a projector,
    Zamba's shared block) is gathered where it is first read and kept
    whole through the backward, as FSDP keeps its root module's: the
    tied embedding is read at both ends of the network and its backward
    starts at once, so one gather and one reduce-scatter serve both
    reads. :func:`subtree`, :func:`nest` and :func:`unstack` keep the
    blocks and carry the splits along."""

    def __init__(self, leaves: dict, split: dict, wholes=None, scope=None):
        self._leaves = dict(leaves)
        self.split = {k: s for k, s in split.items() if k in self._leaves}
        self._wholes = _Wholes() if wholes is None else wholes
        self._scope = scope

    def __getitem__(self, k):
        x = self._leaves[k]
        s = self.split.get(k)
        return x if s is None else self._wholes.get(self._scope, x, *s)

    def __iter__(self):
        return iter(self._leaves)

    def __len__(self) -> int:
        return len(self._leaves)

    def __contains__(self, k) -> bool:
        return k in self._leaves

    def view(self, leaves: dict, split: dict, scope=None) -> "Blocks":
        """Blocks of the same tree (its gathered leaves shared)."""
        return Blocks(leaves, split, self._wholes,
                      self._scope if scope is None else scope)


def subtree(params: dict, prefix: str) -> dict:
    """The leaves under ``prefix`` (a dotted path ending in "."), named
    from there on (:class:`Blocks` stay blocks)."""
    if isinstance(params, Blocks):
        n = len(prefix)
        return params.view(
            {k[n:]: v for k, v in params._leaves.items()
             if k.startswith(prefix)},
            {k[n:]: s for k, s in params.split.items()
             if k.startswith(prefix)})
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def nest(flat: dict) -> dict:
    """One level of nesting by the first name segment: ``{"ln1": a,
    "attn.wq.w": b}`` -> ``{"ln1": a, "attn": {"wq.w": b}}`` (of
    :class:`Blocks`, Blocks)."""
    if isinstance(flat, Blocks):
        top, split = {}, {}
        for k, v in flat._leaves.items():
            head, _, rest = k.partition(".")
            if not rest:
                top[k] = v
                if k in flat.split:
                    split[k] = flat.split[k]
            elif head not in top:
                top[head] = subtree(flat, head + ".")
        return flat.view(top, split)
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
    leaf). Of :class:`Blocks`, Blocks each in a scope of its own, the
    split dims moved down by one; a leaf split along the stacked axis
    itself (each rank holds some of the layers) is gathered whole here."""
    if not isinstance(leaves, Blocks):
        n = next(iter(leaves.values())).shape[0]
        out = [{} for _ in range(n)]
        for k, v in leaves.items():
            for d, x in zip(out, v.unbind(0)):
                d[k] = x
        return out
    parts, split = {}, {}
    for k, v in leaves._leaves.items():
        s = leaves.split.get(k)
        if s is not None and s[0] == 0:
            v, s = leaves[k], None
        parts[k] = v.unbind(0)
        if s is not None:
            split[k] = (s[0] - 1, s[1])
    token = object()
    n = len(next(iter(parts.values())))
    return [leaves.view({k: p[i] for k, p in parts.items()}, split,
                        (leaves._scope, token, i)) for i in range(n)]


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
    N - 1: the whole loop's flops, forward and backward, and its
    collectives (``parallel.Census``), each counted N times as the
    reference counts a while body's by its trip count."""
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
