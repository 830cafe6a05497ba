"""Mamba2 (SSD) block, as the reference's ``models/mamba2.py``: the
chunked state-space-dual form for train and prefill (chunks of
``CHUNK``; a length that is not a multiple of it is one chunk) and an
O(1) recurrent decode step. n_groups = 1 (B and C shared across heads),
as in the reference.

Params of one layer are a flat name -> tensor dict (``in_proj.w``,
``conv_w``, ``a_log``, ...). The scan and the state are f32 whatever the
compute dtype; ``softplus`` is JAX's form (``layers.softplus``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

CHUNK = 256


def dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_headdim
    conv_dim = d_in + 2 * cfg.ssm_state
    return d_in, nheads, conv_dim


def init_mamba(gen: torch.Generator, cfg) -> dict:
    """One layer's leaves; ``a_log`` and ``dt_bias`` from the reference's
    f32 linspaces (``layers.linspace_f32``)."""
    d_in, nheads, conv_dim = dims(cfg)
    dev = gen.device
    proj_out = 2 * d_in + 2 * cfg.ssm_state + nheads     # z, x, B, C, dt
    return {
        "a_log": torch.log(L.linspace_f32(1.0, 16.0, nheads, dev)),
        "conv_b": torch.zeros((conv_dim,), device=dev),
        "conv_w": torch.randn((conv_dim, cfg.conv_width), generator=gen,
                              device=dev) * (1.0 / math.sqrt(cfg.conv_width)),
        "d_skip": torch.ones((nheads,), device=dev),
        "dt_bias": torch.log(torch.expm1(L.linspace_f32(1e-3, 0.1, nheads,
                                                        dev))),
        "gate_norm": torch.ones((d_in,), device=dev),
        "in_proj.w": L.init_dense(gen, cfg.d_model, proj_out)["w"],
        "out_proj.w": L.init_dense(
            gen, d_in, cfg.d_model,
            scale=1.0 / math.sqrt(d_in * 2 * cfg.num_layers))["w"],
    }


def _split_proj(p: dict, u: torch.Tensor, cfg):
    """(z, x, B, C, dt) of the input projection."""
    d_in, nheads, _ = dims(cfg)
    n = cfg.ssm_state
    return L.proj(p, "in_proj", u).split([d_in, d_in, n, n, nheads], dim=-1)


def _ssd_scan(x, bmat, cmat, dt, a, cfg, init_state=None):
    """Chunked SSD. x: (B, T, H, P); bmat / cmat: (B, T, N); dt: (B, T, H)
    (after softplus); a: (H,), negative. Returns (y (B, T, H, P) in x's
    dtype, final state (B, H, P, N) f32)."""
    b, t, h, p = x.shape
    n = bmat.shape[-1]
    q = CHUNK if t % CHUNK == 0 else t
    acc = L.acc_dtype(x.dtype)
    da = dt * a[None, None, :]                         # log-decay (< 0)
    state = (torch.zeros((b, h, p, n), dtype=acc, device=x.device)
             if init_state is None else init_state.to(acc))
    above = ~torch.ones((q, q), dtype=torch.bool,
                        device=x.device).tril()[None, :, :, None]

    def chunk(_, carry, xs):
        state, = carry
        xq, bq, cq = (y.to(acc) for y in xs[:3])
        dtq, daq = xs[3:]
        cum = torch.cumsum(daq, dim=1)                 # (B, Q, H)
        # intra-chunk: y_i += sum_{j<=i} (C_i.B_j) exp(cum_i-cum_j) dt_j x_j
        seg = cum[:, :, None, :] - cum[:, None, :, :]  # (B, Q, Q, H) i, j
        lmat = torch.exp(seg.masked_fill(above, -math.inf))
        scores = torch.einsum("bin,bjn->bij", cq, bq)  # (B, Q, Q)
        m = scores[..., None] * lmat * dtq[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", m, xq)
        # inter-chunk: y_i += exp(cum_i) C_i . state
        y_inter = torch.einsum("bqn,bhpn->bqhp", cq, state) \
            * torch.exp(cum)[..., None]
        # S' = exp(cum_last) S + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
        wj = torch.exp(cum[:, -1:, :] - cum) * dtq     # (B, Q, H)
        state = torch.exp(cum[:, -1])[:, :, None, None] * state \
            + torch.einsum("bqhp,bqn->bhpn", xq * wj[..., None], bq)
        return (state,), (y_intra + y_inter).to(x.dtype)

    # the chunks are the scan's steps (the reference's lax.scan over them)
    (state,), ys = L.scan(chunk, (state,), tuple(
        y.reshape(b, t // q, q, *y.shape[2:]) for y in (x, bmat, cmat, dt, da)))
    return ys.reshape(b, t, h, p), state


def _dt(dt_raw: torch.Tensor, p: dict) -> torch.Tensor:
    """softplus(dt in f32 + dt_bias): the bias in its own dtype (bf16
    when compressed for training), promoted as JAX promotes."""
    return L.softplus(dt_raw.to(L.acc_dtype(dt_raw.dtype)) + p["dt_bias"])


def mamba_forward(p: dict, u: torch.Tensor, cfg, state=None):
    """u: (B, T, D) -> (out (B, T, D), decode-ready {conv, ssm})."""
    b, t, _ = u.shape
    d_in, nheads, _ = dims(cfg)
    z, x, bmat, cmat, dt = _split_proj(p, u, cfg)
    xbc_raw = torch.cat([x, bmat, cmat], dim=-1)
    xbc = L.causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    x, bmat, cmat = xbc.split([d_in, cfg.ssm_state, cfg.ssm_state], dim=-1)
    dt = _dt(dt, p)
    a = -torch.exp(p["a_log"])
    xh = x.reshape(b, t, nheads, cfg.ssm_headdim)
    y, fstate = _ssd_scan(xh, bmat, cmat, dt, a, cfg,
                          None if state is None else state["ssm"])
    y = y + xh * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = L.rms_norm(y.reshape(b, t, d_in) * F.silu(z), p["gate_norm"],
                   cfg.norm_eps)
    w1 = cfg.conv_width - 1
    tail = xbc_raw[:, -w1:, :] if t >= w1 else F.pad(xbc_raw,
                                                    (0, 0, w1 - t, 0))
    return L.proj(p, "out_proj", y), {
        "conv": tail.to(getattr(torch, cfg.dtype)), "ssm": fstate}


def init_mamba_state(cfg, batch: int, device) -> dict:
    d_in, nheads, conv_dim = dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                            dtype=getattr(torch, cfg.dtype), device=device),
        "ssm": torch.zeros((batch, nheads, cfg.ssm_headdim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


def mamba_decode(p: dict, u: torch.Tensor, state: dict, cfg):
    """One recurrent step. u: (B, 1, D). Returns (out (B, 1, D), state)."""
    b = u.shape[0]
    d_in, nheads, _ = dims(cfg)
    z, x, bmat, cmat, dt = _split_proj(p, u, cfg)
    window = torch.cat([state["conv"], torch.cat([x, bmat, cmat], dim=-1)],
                       dim=1)                          # (B, W, C)
    xbc1 = L.causal_conv_step(window, p["conv_w"], p["conv_b"])
    x, bmat, cmat = xbc1.split([d_in, cfg.ssm_state, cfg.ssm_state], dim=-1)
    dt = _dt(dt, p)[:, 0]                              # (B, H)
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt * a[None, :])
    acc = L.acc_dtype(x.dtype)
    xh = x.reshape(b, nheads, cfg.ssm_headdim).to(acc)
    bn, cn = bmat.to(acc), cmat.to(acc)                # (B, N)
    new_ssm = decay[:, :, None, None] * state["ssm"] \
        + torch.einsum("bhp,bn->bhpn", xh * dt[..., None], bn)
    y = torch.einsum("bn,bhpn->bhp", cn, new_ssm)     # (B, H, P)
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(b, 1, d_in).to(u.dtype)
    y = L.rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return L.proj(p, "out_proj", y), {"conv": window[:, 1:, :],
                                      "ssm": new_ssm}
