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

On a mesh of several ranks the train loss runs on each rank's blocks of
the leaves, split over "model" by the reference's ``param_spec_tree``
(:func:`mlstm_forward`, :func:`slstm_forward`; the embedding and
``lm_head`` on the vocabulary), and so do prefill and decode, on each
rank's blocks of the deployed params and of the cache
(:func:`mlstm_decode`, :func:`slstm_decode`).

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
from repro_torch.models import parallel
from repro_torch.models.decoder import (compute_dtype, head_layout,
                                        make_generator, serve_logits,
                                        unembed_head, vocab_layout)
from repro_torch.models.sharding import cache_model_dim

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


def _mlstm_cell_chunked(q, k, v, igate, log_f, state=None, split=False):
    """q, k: (B, T, H, dk); v: (B, T, H, hd); igate: (B, T, H) in (0, 1);
    log_f: (B, T, H) (< 0). Returns (h (B, T, H, hd) in q's dtype,
    (C (B, H, hd, dk), n (B, H, dk))). A length that is not a multiple of
    CHUNK is one chunk of T, as in the reference. With ``split``, q and k
    are this rank's block of dk (dk < hd) and so are C and n: each
    chunk's sums over dk are partial, and its numerator and denominator
    are summed over "model" (:func:`_sum_over_dk`) before the division;
    the state's update is elementwise in dk, so C and n stay blocks."""
    b, t, h, hd = v.shape
    dk = k.shape[-1]
    qc = t if t % CHUNK else CHUNK
    scale = 1.0 / math.sqrt(hd)
    acc = L.acc_dtype(q.dtype)
    if state is None:
        cmat = torch.zeros((b, h, hd, dk), dtype=acc, device=q.device)
        nvec = torch.zeros((b, h, dk), dtype=acc, device=q.device)
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
        num, den = y_intra + y_inter, qn_intra + qn_inter
        if split:
            num, den = _sum_over_dk(num, den)
        hvec = num / torch.clamp_min(torch.abs(den), 1.0)[..., None]
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


def _dk_block(b: int, cfg) -> int:
    """The width of this rank's block of the mLSTM state's dk: hd / M
    where ``sharding.cache_spec_tree``'s rule puts ``mC`` (B, H, hd, hd)
    on its dk over "model" (its heads do not split over the M ranks),
    else hd."""
    _, hd, _ = dims(cfg)
    if parallel.group("model") is None:
        return hd
    m = parallel.size("model")
    return (hd // m if cache_model_dim("mC", (b, cfg.num_heads, hd, hd), m)
            == 3 else hd)


def _narrow_dk(y: torch.Tensor, dk: int) -> torch.Tensor:
    """This rank's block of ``dk`` of the last dim of ``y``."""
    return y.narrow(-1, parallel.rank("model") * dk, dk)


def _sum_over_dk(num: torch.Tensor, den: torch.Tensor):
    """The mLSTM read-out's numerator (..., hd) and denominator (...),
    each rank's partial sums over its block of dk, summed over "model"
    in one all-reduce (``parallel.sum_over``)."""
    both = parallel.sum_over(torch.cat([num, den[..., None]], -1), "model")
    return both[..., :-1], both[..., -1]


def mlstm_forward(p: dict, x: torch.Tensor, cfg, state=None):
    """x: (B, T, D) -> (x + out, {conv, mC, mn}).

    Over "model" the reference splits the columns of ``up``, ``qkv`` and
    ``gates``, which do not line up with xc|z, q|k|v or i|f: each
    output is gathered whole (``layers.proj_whole``) and the conv, whole
    in the reference too, runs alike on every rank. ``mnorm``, ``skip``
    and ``down``'s rows split d_in, which lines up with the heads: each
    rank runs the cell on its heads (its block of q, k, v and the
    gates), then the norm, the skip and the gate on its block of d_in
    and ``down`` on its rows (``layers.norm_proj_rows``). Where the heads
    do not split, every rank runs them all and takes its block after;
    a forward that takes no gradient (the prefill) then runs the cell on
    this rank's block of dk where the cache rule puts ``mC`` there
    (:func:`_dk_block`), its sums over dk summed over "model" once a
    chunk (a sum whose gradient would not flow back), and returns ``mC``
    and ``mn`` as those blocks."""
    b, t, _ = x.shape
    d_in, hd, _ = dims(cfg)
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    xc_raw, z = L.proj_whole(p, "up", h, 2 * d_in).chunk(2, dim=-1)
    xc = L.causal_conv(xc_raw, p["conv_w"], p["conv_b"])
    xm = parallel.copy_to_model(xc)     # the input of both split products
    q, k, v = L.proj_whole(p, "qkv", xc, 3 * d_in, xm).chunk(3, dim=-1)
    gates = L.proj_whole(p, "gates", xc, 2 * cfg.num_heads, xm)
    gates = gates.to(L.acc_dtype(gates.dtype))
    i_raw, f_raw = gates.chunk(2, dim=-1)                      # (B, T, H)
    width = p["mnorm"].shape[-1]        # d_in, or this rank's block of it
    heads = width != d_in and width % hd == 0           # this rank's heads
    if heads:
        q, k, v, i_raw, f_raw = (parallel.split_to_model(y, -1)
                                 for y in (q, k, v, i_raw, f_raw))
    igate = torch.sigmoid(i_raw)
    log_f = L.log_sigmoid(f_raw)
    shape = (b, t, -1, hd)
    q, k, v = (y.reshape(shape) for y in (q, k, v))
    dk = hd if heads or torch.is_grad_enabled() else _dk_block(b, cfg)
    if dk != hd:                        # this rank's block of dk
        q, k = _narrow_dk(q, dk), _narrow_dk(k, dk)
    hout, (cmat, nvec) = _mlstm_cell_chunked(
        q, k, v, igate, log_f,
        None if state is None else (state["mC"], state["mn"]), dk != hd)
    out = L.norm_proj_rows(
        p, "down", hout.reshape(b, t, -1), p["mnorm"], d_in, cfg.norm_eps,
        lambda h, local: (h + p["skip"].to(x.dtype) * local(xc))
        * F.silu(local(z)))
    return x + out, {"conv": _conv_tail(xc_raw, cfg.conv_width),
                     "mC": cmat, "mn": nvec}


def mlstm_decode(p: dict, x: torch.Tensor, state: dict, cfg):
    """x: (B, 1, D); state: {conv (B, W-1, d_in), mC (B, H, hd, hd),
    mn (B, H, hd)}. Returns (x + out, new state).

    On a mesh of several ranks ``state`` is this rank's block of the
    cache (``sharding.cache_spec_tree``: ``conv`` on its d_in channels,
    ``mC`` / ``mn`` on its heads, else on their last dim) and the leaves
    its blocks, as :func:`mlstm_forward` takes them: ``up``, ``qkv`` and
    ``gates`` are gathered whole, the depthwise conv runs on this rank's
    channels (the whole ``conv_w`` and ``conv_b``'s block of them) and is
    gathered whole, and the cell runs on this rank's heads, or, where the
    heads do not split, on every head with this rank's block of dk (that
    of ``mC`` and ``mn``; q and k cut to it): ``mC`` and ``mn`` update on
    their blocks, and the read-out's sums over dk are summed over
    "model"; then the norm, the skip, the gate and ``down`` as in the
    forward."""
    b = x.shape[0]
    d_in, hd, _ = dims(cfg)
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    xc, z = L.proj_whole(p, "up", h, 2 * d_in).chunk(2, dim=-1)
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    if state["conv"].shape[-1] != d_in:         # this rank's channels
        xc = parallel.block(xc, "model", -1)
        conv_w = parallel.block(conv_w, "model", 0)
        conv_b = parallel.block(conv_b, "model", -1)
    window = torch.cat([state["conv"], xc], dim=1)
    xc1 = L.cache_whole(L.causal_conv_step(window, conv_w, conv_b), -1,
                        d_in)[:, None, :]
    xm = parallel.copy_to_model(xc1)
    q, k, v = L.proj_whole(p, "qkv", xc1, 3 * d_in, xm).chunk(3, dim=-1)
    gates = L.proj_whole(p, "gates", xc1, 2 * cfg.num_heads, xm)
    acc = L.acc_dtype(gates.dtype)
    i_raw, f_raw = gates.to(acc).chunk(2, dim=-1)
    width = p["mnorm"].shape[-1]
    if width != d_in and width % hd == 0:       # this rank's heads
        q, k, v, i_raw, f_raw = (parallel.split_to_model(y, -1)
                                 for y in (q, k, v, i_raw, f_raw))
    ig = torch.sigmoid(i_raw)[:, 0]                            # (B, H)
    fg = torch.sigmoid(f_raw)[:, 0]
    qh, kh, vh = (y.reshape(b, -1, hd).to(acc) for y in (q, k, v))
    dk = state["mC"].shape[-1]
    if dk != hd:                                # this rank's block of dk
        qh, kh = _narrow_dk(qh, dk), _narrow_dk(kh, dk)
    cmat = fg[..., None, None] * state["mC"] \
        + ig[..., None, None] * torch.einsum("bhv,bhk->bhvk", vh, kh)
    nvec = fg[..., None] * state["mn"] + ig[..., None] * kh
    scale = 1.0 / math.sqrt(hd)
    y = torch.einsum("bhk,bhvk->bhv", qh, cmat) * scale
    qn = torch.einsum("bhk,bhk->bh", qh, nvec) * scale
    if dk != hd:
        y, qn = _sum_over_dk(y, qn)
    y = y / torch.clamp_min(torch.abs(qn), 1.0)[..., None]
    out = L.norm_proj_rows(
        p, "down", y.reshape(b, 1, -1).to(x.dtype), p["mnorm"], d_in,
        cfg.norm_eps, lambda h, local: (h + p["skip"].to(x.dtype)
                                        * local(xc1)) * F.silu(local(z)))
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
    (a copy per step would keep T copies alive for the backward).

    Over "model" the reference splits ``gates_x``'s columns (which do not
    line up with the heads: its output is gathered whole), ``r_gates``
    on its last dim, and ``gnorm`` and ``down``'s rows on d_model, which
    lines up with the heads. The recurrence is block-diagonal by head, so
    each rank gathers ``r_gates`` whole once and runs the T steps on its
    heads with no communication, then the norm over its block and
    ``down`` on its rows, the partial outputs summed. Where the heads do
    not split, every rank runs them all and takes its block after."""
    b, t, d = x.shape
    hds = d // cfg.num_heads
    xin = L.rms_norm(x, p["ln"], cfg.norm_eps)
    g = L.proj_whole(p, "gates_x", xin, 4 * d).reshape(b, t, 4,
                                                         cfg.num_heads, hds)
    width = p["gnorm"].shape[-1]        # d, or this rank's block of it
    heads = width != d and width % hds == 0             # this rank's heads
    r = p["r_gates"]
    if r.shape[-1] != hds:      # each rank's use differs where heads split
        r = (parallel.gather_to_ranks if heads
             else parallel.gather_from_model)(r, -1)
    elif heads:
        r = parallel.copy_to_model(r)
    if heads:
        g = parallel.split_to_model(g, 3)
        hl = g.shape[3]
        r = r.narrow(1, parallel.rank("model") * hl, hl)
    gx = _gates_ifoz(g)
    if state is None:
        z = torch.zeros((b, gx.shape[3], hds), dtype=gx.dtype,
                        device=x.device)
        state = (z, z, z)
    rm = _r_matrix(r, torch.promote_types(state[2].dtype, r.dtype))

    def step(c, st, g):
        st = _slstm_cell(c[0], g[0], st)
        return st, st[2]

    state, hs = L.scan(step, state, (gx,), (rm,))
    out = L.norm_proj_rows(p, "down", hs.reshape(b, t, -1).to(x.dtype),
                           p["gnorm"], d, cfg.norm_eps)
    return x + out, {"sc": state[0], "sn": state[1], "sh": state[2]}


def slstm_decode(p: dict, x: torch.Tensor, state: dict, cfg):
    """One sLSTM step. On a mesh of several ranks ``state`` is this rank's
    block of the cache (``sc`` / ``sn`` / ``sh`` on its heads, else on
    their last dim) and the leaves its blocks, as :func:`slstm_forward`
    takes them: ``gates_x``'s output and ``r_gates`` gathered whole, the
    step on this rank's heads, or, where the heads do not split, on every
    head with the state gathered whole for the step and cut to its block
    after; then the norm over this rank's block and ``down``'s rows."""
    b, _, d = x.shape
    hds = d // cfg.num_heads
    xin = L.rms_norm(x, p["ln"], cfg.norm_eps)
    gx = L.proj_whole(p, "gates_x", xin, 4 * d).reshape(b, 4, cfg.num_heads,
                                                         hds)
    r = p["r_gates"]
    if r.shape[-1] != hds:
        r = parallel.gather_from_model(r, -1)
    width = p["gnorm"].shape[-1]
    if width != d and width % hds == 0:         # this rank's heads
        gx = parallel.split_to_model(gx, 2)
        r = r.narrow(1, parallel.rank("model") * gx.shape[2], gx.shape[2])
    st = tuple(L.cache_whole(state[k], -1, hds) for k in ("sc", "sn", "sh"))
    st = _slstm_cell(_r_matrix(r, torch.promote_types(st[2].dtype, r.dtype)),
                     _gates_ifoz(gx), st)
    out = L.norm_proj_rows(p, "down", st[2].reshape(b, 1, -1).to(x.dtype),
                           p["gnorm"], d, cfg.norm_eps)
    whole = (b, cfg.num_heads, hds)
    return x + out, {k: L.cache_block(v, k, whole)
                     for k, v in zip(("sc", "sn", "sh"), st)}


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


def forward(params: dict, tokens: torch.Tensor, cfg, *, window: int = 0,
            num_groups: int = 1):
    """Returns (logits (B, T, V) f32, aux 0): on a mesh of several ranks
    this rank's block of the vocabulary where ``lm_head.w`` splits it
    (:func:`decoder.head_layout`)."""
    x = L.embed(params["embed"], tokens, compute_dtype(cfg),
                vocab_layout(params["embed"], cfg, 0))
    for mls, sp in _superblocks(params):
        for lp in mls:
            x, _ = mlstm_forward(lp, x, cfg)
        x, _ = slstm_forward(sp, x, cfg)
    return unembed_head(params, x, cfg, head_layout(params, cfg)), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params: dict, batch: dict, cfg, *, num_groups: int = 1):
    tokens = batch["tokens"]
    logits, _ = forward(params, tokens[:, :-1], cfg)
    return L.cross_entropy(logits, tokens[:, 1:], vocab_split=head_layout(
        params, cfg) == L.VOCAB)


def prefill(params: dict, tokens: torch.Tensor, cfg, *, window: int = 0,
            num_groups: int = 1):
    """Full-sequence forward that fills the recurrent state. Returns
    (last-token logits (B, 1, V), cache)."""
    x = L.embed(params["embed"], tokens, compute_dtype(cfg),
                vocab_layout(params["embed"], cfg, 0))
    b = tokens.shape[0]
    _, _, hds = dims(cfg)
    mstates, sstates = [], []
    for mls, sp in _superblocks(params):
        per = []
        for lp in mls:
            x, st = mlstm_forward(lp, x, cfg)
            st["conv"] = L.cache_block(st["conv"], "conv")
            per.append(st)
        x, st = slstm_forward(sp, x, cfg)
        st = {k: L.cache_block(v, k, (b, cfg.num_heads, hds))
              for k, v in st.items()}
        mstates.append({k: torch.stack([s[k] for s in per]) for k in per[0]})
        sstates.append(st)
    cache = {"mlstm": {k: torch.stack([s[k] for s in mstates])
                       for k in mstates[0]},
             "slstm": {k: torch.stack([s[k] for s in sstates])
                       for k in sstates[0]}}
    return serve_logits(params, x[:, -1:, :], cfg), cache


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
    x = L.embed(params["embed"], tokens, compute_dtype(cfg),
                vocab_layout(params["embed"], cfg, 0))
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
    return serve_logits(params, x, cfg), cache
