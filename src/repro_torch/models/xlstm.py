"""xLSTM, as the reference's ``models/xlstm.py``: superblocks of
(slstm_every - 1) mLSTM layers and one sLSTM layer.

mLSTM (matrix memory) runs a chunked parallel form for train and prefill
(linear attention with a per-step scalar forget-gate decay, chunks of
``CHUNK``) and an O(1) state update for decode; sLSTM (scalar memory,
block-diagonal recurrence) is a Python loop over time. Input and forget
gates are sigmoids, the reference's documented adaptation.

Params are one name -> tensor dict under the reference's names and stack
axes: ``blocks.mlstm.*`` is (n_superblocks, n_mlstm_per_block, ...),
``blocks.slstm.*`` is (n_superblocks, ...), so the compression sees the
reference's 19 leaves (18 compressible: the stacked per-layer vectors
count as matrices). The reference's ``lax.scan`` over layers is a Python
loop; its ``remat`` and sharding hints (memory and placement, no
numerics) are left out. Every cast of the reference is kept: products
in f32, states in f32, gates cast to f32 after their projection in the
compute dtype. Decode writes the cache in place.

One departure (ROADMAP queue 3): the reference builds the intra-chunk
decay as ``where(tri, exp(seg), 0)``, whose ``exp`` overflows above the
diagonal of a 256-long chunk, so its backward multiplies 0 by inf and
its gradients are NaN at two chunks and more. Here ``seg`` is masked
with -inf before the ``exp``, as the reference's Mamba2 scan does: the
same forward bits, and the reference's gradients wherever those are
finite.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.scenario import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.decoder import compute_dtype, make_generator

CHUNK = 256


def dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model        # mLSTM inner width
    hd = d_in // cfg.num_heads                 # mLSTM head dim
    hds = cfg.d_model // cfg.num_heads         # sLSTM head dim
    return d_in, hd, hds


def n_mlstm_per_block(cfg) -> int:
    return cfg.slstm_every - 1


def n_superblocks(cfg) -> int:
    return cfg.num_layers // cfg.slstm_every


# ----------------------------------------------------------------- mLSTM

def _named(prefix: str, p: dict) -> dict:
    return {prefix + k: v for k, v in p.items()}


def init_mlstm(gen: torch.Generator, cfg) -> dict:
    d_in, _, _ = dims(cfg)
    dev = gen.device
    return {
        "ln": torch.ones((cfg.d_model,), device=dev),
        **_named("up.", L.init_dense(gen, cfg.d_model, 2 * d_in)),
        "conv_w": torch.randn((d_in, cfg.conv_width), generator=gen,
                              device=dev) * (1.0 / math.sqrt(cfg.conv_width)),
        "conv_b": torch.zeros((d_in,), device=dev),
        **_named("qkv.", L.init_dense(gen, d_in, 3 * d_in)),
        **_named("gates.", L.init_dense(gen, d_in, 2 * cfg.num_heads,
                                        bias=True)),
        "mnorm": torch.ones((d_in,), device=dev),
        "skip": torch.ones((d_in,), device=dev),
        **_named("down.", L.init_dense(
            gen, d_in, cfg.d_model,
            scale=1.0 / math.sqrt(d_in * 2 * cfg.num_layers))),
    }


def _mlstm_cell_chunked(q, k, v, igate, log_f, state=None):
    """q, k, v: (B, T, H, hd); igate: (B, T, H) in (0, 1); log_f: (B, T, H)
    (< 0). Returns (h (B, T, H, hd) in q's dtype, (C (B, H, hd, hd),
    n (B, H, hd))). A length that is not a multiple of CHUNK is one
    chunk of T, as in the reference."""
    b, t, h, hd = q.shape
    qc = t if t % CHUNK else CHUNK
    scale = 1.0 / math.sqrt(hd)
    acc = L.acc_dtype(q.dtype)
    if state is None:
        cmat = torch.zeros((b, h, hd, hd), dtype=acc, device=q.device)
        nvec = torch.zeros((b, h, hd), dtype=acc, device=q.device)
    else:
        cmat, nvec = state
    above = ~torch.ones((qc, qc), dtype=torch.bool,
                        device=q.device).tril()[None, :, :, None]

    def chunk(_, state, xs):
        cmat, nvec = state
        qq, kk, vv = (x.to(acc) for x in xs[:3])
        ii, lf = xs[3:]
        cum = torch.cumsum(lf, dim=1)                          # (B, qc, H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]          # (B, i, j, H)
        w = torch.exp(seg.masked_fill(above, -math.inf))       # decay i >= j
        att = torch.einsum("bihd,bjhd->bijh", qq, kk) * scale
        a = att * w * ii[:, None, :, :]                        # (B, i, j, H)
        y_intra = torch.einsum("bijh,bjhd->bihd", a, vv)
        qn_intra = torch.sum(a, dim=2)                         # (B, i, H)
        dec = torch.exp(cum)                                   # (B, i, H)
        y_inter = torch.einsum("bihk,bhvk->bihv", qq, cmat) \
            * scale * dec[..., None]
        qn_inter = torch.einsum("bihk,bhk->bih", qq, nvec) * scale * dec
        hvec = (y_intra + y_inter) / torch.clamp_min(
            torch.abs(qn_intra + qn_inter), 1.0)[..., None]
        # state update
        wj = torch.exp(cum[:, -1:, :] - cum) * ii              # (B, j, H)
        cmat = dec[:, -1][:, :, None, None] * cmat + torch.einsum(
            "bjhv,bjhk->bhvk", vv * wj[..., None], kk)
        nvec = dec[:, -1][:, :, None] * nvec + torch.einsum(
            "bjhk,bjh->bhk", kk, wj)
        return (cmat, nvec), hvec.to(q.dtype)

    # the chunks are the scan's steps (the reference's lax.scan over them)
    (cmat, nvec), hs = L.scan(chunk, (cmat, nvec), tuple(
        x.reshape(b, t // qc, qc, *x.shape[2:])
        for x in (q, k, v, igate, log_f)))
    return hs.reshape(b, t, h, hd), (cmat, nvec)


def _conv_tail(x_raw: torch.Tensor, width: int) -> torch.Tensor:
    """The decode-ready conv state: the last W-1 raw (pre-conv) inputs,
    left-padded with zeros when T < W-1."""
    w1 = width - 1
    t = x_raw.shape[1]
    return x_raw[:, -w1:, :] if t >= w1 else F.pad(x_raw,
                                                  (0, 0, w1 - t, 0))


def mlstm_forward(p: dict, x: torch.Tensor, cfg, state=None):
    """x: (B, T, D) -> (x + out, {conv, mC, mn})."""
    b, t, _ = x.shape
    d_in, hd, _ = dims(cfg)
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    xc_raw, z = L.proj(p, "up", h).chunk(2, dim=-1)
    xc = L.causal_conv(xc_raw, p["conv_w"], p["conv_b"])
    q, k, v = L.proj(p, "qkv", xc).chunk(3, dim=-1)
    gates = L.proj(p, "gates", xc)
    gates = gates.to(L.acc_dtype(gates.dtype))
    i_raw, f_raw = gates.chunk(2, dim=-1)                      # (B, T, H)
    igate = torch.sigmoid(i_raw)
    log_f = L.log_sigmoid(f_raw)
    heads = (b, t, cfg.num_heads, hd)
    hout, (cmat, nvec) = _mlstm_cell_chunked(
        q.reshape(heads), k.reshape(heads), v.reshape(heads), igate, log_f,
        None if state is None else (state["mC"], state["mn"]))
    hout = hout.reshape(b, t, d_in)
    hout = L.rms_norm(hout, p["mnorm"], cfg.norm_eps) \
        + p["skip"].to(x.dtype) * xc
    out = L.proj(p, "down", hout * F.silu(z))
    return x + out, {"conv": _conv_tail(xc_raw, cfg.conv_width),
                     "mC": cmat, "mn": nvec}


def mlstm_decode(p: dict, x: torch.Tensor, state: dict, cfg):
    """x: (B, 1, D); state: {conv (B, W-1, d_in), mC (B, H, hd, hd),
    mn (B, H, hd)}. Returns (x + out, new state)."""
    b = x.shape[0]
    d_in, hd, _ = dims(cfg)
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    xc, z = L.proj(p, "up", h).chunk(2, dim=-1)
    window = torch.cat([state["conv"], xc], dim=1)
    xc1 = L.causal_conv_step(window, p["conv_w"], p["conv_b"])[:, None, :]
    q, k, v = L.proj(p, "qkv", xc1).chunk(3, dim=-1)
    gates = L.proj(p, "gates", xc1)
    acc = L.acc_dtype(gates.dtype)
    i_raw, f_raw = gates.to(acc).chunk(2, dim=-1)
    ig = torch.sigmoid(i_raw)[:, 0]                            # (B, H)
    fg = torch.sigmoid(f_raw)[:, 0]
    qh, kh, vh = (y.reshape(b, cfg.num_heads, hd).to(acc) for y in (q, k, v))
    cmat = fg[..., None, None] * state["mC"] + ig[..., None, None] \
        * torch.einsum("bhv,bhk->bhvk", vh, kh)
    nvec = fg[..., None] * state["mn"] + ig[..., None] * kh
    scale = 1.0 / math.sqrt(hd)
    y = torch.einsum("bhk,bhvk->bhv", qh, cmat) * scale
    qn = torch.einsum("bhk,bhk->bh", qh, nvec) * scale
    y = y / torch.clamp_min(torch.abs(qn), 1.0)[..., None]
    hout = y.reshape(b, 1, d_in).to(x.dtype)
    hout = L.rms_norm(hout, p["mnorm"], cfg.norm_eps) \
        + p["skip"].to(x.dtype) * xc1
    out = L.proj(p, "down", hout * F.silu(z))
    return x + out, {"conv": window[:, 1:, :], "mC": cmat, "mn": nvec}


# ----------------------------------------------------------------- sLSTM

def init_slstm(gen: torch.Generator, cfg) -> dict:
    _, _, hds = dims(cfg)
    dev = gen.device
    return {
        "ln": torch.ones((cfg.d_model,), device=dev),
        **_named("gates_x.", L.init_dense(gen, cfg.d_model, 4 * cfg.d_model,
                                          bias=True)),
        "r_gates": torch.randn((4, cfg.num_heads, hds, hds), generator=gen,
                               device=dev) * (1.0 / math.sqrt(hds)),
        "gnorm": torch.ones((cfg.d_model,), device=dev),
        **_named("down.", L.init_dense(
            gen, cfg.d_model, cfg.d_model,
            scale=1.0 / math.sqrt(cfg.d_model * 2 * cfg.num_layers))),
    }


# the sLSTM gates, reordered once per sequence from the reference's
# (i, f, z, o) to (i, f, o, z): one sigmoid over the first three a step
_IFOZ = (0, 1, 3, 2)


def _r_matrix(r: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``r_gates`` (4, H, d, e) as (H, d, 4 e) in ``dt``, the gates in
    (i, f, o, z) order: the recurrent product of all four as one batched
    matmul over the heads."""
    g, h, d, e = r.shape
    return r[list(_IFOZ)].to(dt).permute(1, 2, 0, 3).reshape(h, d, g * e)


def _slstm_cell(rm: torch.Tensor, gx_t: torch.Tensor, state):
    """One sLSTM step: rm from :func:`_r_matrix`; gx_t (B, 4, H, hds),
    the input's contribution in f32 with the gates in (i, f, o, z) order;
    state (c, n, h)."""
    c, n, h = state
    b, ng, nh, e = gx_t.shape
    rec = torch.bmm(h.transpose(0, 1).to(rm.dtype), rm)       # (H, B, 4 e)
    g = gx_t + rec.view(nh, b, ng, e).permute(1, 2, 0, 3)    # (B, 4, H, e)
    i, f, o = torch.sigmoid(g[:, :3]).unbind(1)
    zv = torch.tanh(g[:, 3])
    c = f * c + i * zv
    n = f * n + i
    h = o * c / torch.clamp_min(n, 1e-6)
    return (c, n, h)


def _gates_ifoz(gx: torch.Tensor) -> torch.Tensor:
    """The input's gate contributions (..., 4, H, hds) cast to f32 (as
    the reference casts them each step) and put in (i, f, o, z) order."""
    return gx.to(L.acc_dtype(gx.dtype))[..., list(_IFOZ), :, :]


def _slstm_step(p: dict, gx_t: torch.Tensor, state, cfg):
    """gx_t: (B, 4, H, hds), the input's contribution (gates in the
    reference's (i, f, z, o) order); state: (c, n, h). The recurrent
    product runs in the promoted dtype of the state and ``r_gates`` (f32
    when the compressed r_gates are bf16), as JAX's einsum promotes."""
    r = p["r_gates"]
    return _slstm_cell(_r_matrix(r, torch.promote_types(state[2].dtype,
                                                        r.dtype)),
                       _gates_ifoz(gx_t), state)


def slstm_forward(p: dict, x: torch.Tensor, cfg, state=None):
    """x: (B, T, D) -> (x + out, {sc, sn, sh}); T steps of
    :func:`_slstm_cell` from Python (:func:`layers.scan`, which the dry
    run counts by its length), the state in f32. The recurrent
    weight and the input gates are cast and laid out once for the T steps
    (a copy per step would keep T copies alive for the backward)."""
    b, t, d = x.shape
    hds = d // cfg.num_heads
    xin = L.rms_norm(x, p["ln"], cfg.norm_eps)
    gx = _gates_ifoz(L.proj(p, "gates_x", xin).reshape(b, t, 4,
                                                       cfg.num_heads, hds))
    if state is None:
        z = torch.zeros((b, cfg.num_heads, hds), dtype=gx.dtype,
                        device=x.device)
        state = (z, z, z)
    rm = _r_matrix(p["r_gates"], torch.promote_types(state[2].dtype,
                                                     p["r_gates"].dtype))
    def step(c, st, g):
        st = _slstm_cell(c[0], g[0], st)
        return st, st[2]

    state, hs = L.scan(step, state, (gx,), (rm,))
    hout = hs.reshape(b, t, d).to(x.dtype)
    hout = L.rms_norm(hout, p["gnorm"], cfg.norm_eps)
    return x + L.proj(p, "down", hout), {"sc": state[0], "sn": state[1],
                                         "sh": state[2]}


def slstm_decode(p: dict, x: torch.Tensor, state: dict, cfg):
    b, _, d = x.shape
    hds = d // cfg.num_heads
    xin = L.rms_norm(x, p["ln"], cfg.norm_eps)
    gx = L.proj(p, "gates_x", xin).reshape(b, 4, cfg.num_heads, hds)
    st = _slstm_step(p, gx, (state["sc"], state["sn"], state["sh"]), cfg)
    hout = st[2].reshape(b, 1, d).to(x.dtype)
    hout = L.rms_norm(hout, p["gnorm"], cfg.norm_eps)
    return x + L.proj(p, "down", hout), {"sc": st[0], "sn": st[1],
                                         "sh": st[2]}


# ------------------------------------------------------------------ model

def init(key, cfg, device=None) -> dict:
    """Random params from ``key`` (an int seed or a ``torch.Generator``),
    drawn on the device, in the reference's flatten order."""
    gen = make_generator(key, device)
    nsb, nm = n_superblocks(cfg), n_mlstm_per_block(cfg)
    params = {
        "embed": L.init_embed(gen, cfg.vocab_size, cfg.d_model),
        "final_norm": torch.ones((cfg.d_model,), device=gen.device),
        "lm_head.w": L.init_dense(gen, cfg.d_model, cfg.vocab_size,
                                  scale=0.02)["w"],
    }
    mlstm = L.stack_layers(nsb, lambda: L.stack_layers(
        nm, lambda: init_mlstm(gen, cfg)))
    slstm = L.stack_layers(nsb, lambda: init_slstm(gen, cfg))
    params.update(_named("blocks.mlstm.", mlstm))
    params.update(_named("blocks.slstm.", slstm))
    return dict(sorted(params.items()))


def _superblocks(params: dict) -> list:
    """Per superblock: (its mLSTM layers' views, its sLSTM layer's view)."""
    mlstm = [L.unstack(sb) for sb in L.unstack(
        L.subtree(params, "blocks.mlstm."))]
    return list(zip(mlstm, L.unstack(L.subtree(params, "blocks.slstm."))))


def _unembed(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """The f32 head: the final norm in the compute dtype, then
    ``lm_head`` on x cast to f32."""
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.proj(params, "lm_head", x.to(torch.float32))


def forward(params: dict, tokens: torch.Tensor, cfg, *, window: int = 0,
            num_groups: int = 1):
    """Returns (logits (B, T, V) f32, aux 0)."""
    x = L.embed(params["embed"], tokens, compute_dtype(cfg))
    for mls, sp in _superblocks(params):
        for lp in mls:
            x, _ = mlstm_forward(lp, x, cfg)
        x, _ = slstm_forward(sp, x, cfg)
    return _unembed(params, x, cfg), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def loss_fn(params: dict, batch: dict, cfg, *, num_groups: int = 1):
    tokens = batch["tokens"]
    logits, _ = forward(params, tokens[:, :-1], cfg)
    return L.cross_entropy(logits, tokens[:, 1:])


def prefill(params: dict, tokens: torch.Tensor, cfg, *, window: int = 0,
            num_groups: int = 1):
    """Full-sequence forward that fills the recurrent state. Returns
    (last-token logits (B, 1, V), cache)."""
    x = L.embed(params["embed"], tokens, compute_dtype(cfg))
    mstates, sstates = [], []
    for mls, sp in _superblocks(params):
        per = []
        for lp in mls:
            x, st = mlstm_forward(lp, x, cfg)
            per.append(st)
        x, st = slstm_forward(sp, x, cfg)
        mstates.append({k: torch.stack([s[k] for s in per]) for k in per[0]})
        sstates.append(st)
    cache = {"mlstm": {k: torch.stack([s[k] for s in mstates])
                       for k in mstates[0]},
             "slstm": {k: torch.stack([s[k] for s in sstates])
                       for k in sstates[0]}}
    return _unembed(params, x[:, -1:, :], cfg), cache


def init_cache(cfg, batch: int, cache_len: int, device=None) -> dict:
    """Zero states under the reference's names; ``cache_len`` is
    irrelevant (constant-size recurrent state)."""
    dev = resolve_device(device)
    nsb, nm = n_superblocks(cfg), n_mlstm_per_block(cfg)
    d_in, hd, hds = dims(cfg)
    f32 = torch.float32
    s_shape = (nsb, batch, cfg.num_heads, hds)
    return {
        "mlstm": {
            "conv": torch.zeros((nsb, nm, batch, cfg.conv_width - 1, d_in),
                                dtype=compute_dtype(cfg), device=dev),
            "mC": torch.zeros((nsb, nm, batch, cfg.num_heads, hd, hd),
                              dtype=f32, device=dev),
            "mn": torch.zeros((nsb, nm, batch, cfg.num_heads, hd),
                              dtype=f32, device=dev),
        },
        "slstm": {k: torch.zeros(s_shape, dtype=f32, device=dev)
                  for k in ("sc", "sn", "sh")},
    }


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                cfg, *, window: int = 0, num_groups: int = 1):
    """One decode step (tokens (B, 1)): every layer's state updated in
    place in ``cache``. Returns (logits (B, 1, V), cache)."""
    x = L.embed(params["embed"], tokens, compute_dtype(cfg))
    mc, sc = cache["mlstm"], cache["slstm"]
    for s, (mls, sp) in enumerate(_superblocks(params)):
        for i, lp in enumerate(mls):
            x, new = mlstm_decode(lp, x, {k: v[s, i] for k, v in mc.items()},
                                  cfg)
            for k, v in new.items():
                mc[k][s, i].copy_(v)
        x, new = slstm_decode(sp, x, {k: v[s] for k, v in sc.items()}, cfg)
        for k, v in new.items():
            sc[k][s].copy_(v)
    return _unembed(params, x, cfg), cache
