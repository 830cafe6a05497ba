"""Port parity for the dry run's counts (``repro_torch.launch.analysis``),
on the CPU at the smoke configs: the port's flops, counted on fake
tensors by ``torch.utils.flop_counter``'s formulas, against the
reference's ``analyze_step`` over its jaxpr.

Dense, VLM and audio prefill and decode agree exactly. Where the two
programs differ, each difference is computed from the shapes and held
exactly:

- train: the reference's ``jax.checkpoint`` recomputes each layer's
  forward in the backward, every matmul but the MLP's last (its output
  feeds only the residual, so XLA drops its recompute);
- MoE: the reference dispatches and combines by one-hot einsums
  (``dot_general``s); the port gathers;
- Zamba: the reference applies the shared block under ``lax.cond`` in
  every layer, and its walk counts a cond's costlier branch, so the
  shared block counts in every layer, not every ``attn_every``-th;
- xLSTM and Zamba: the reference's causal conv is a
  ``conv_general_dilated`` (2 x outputs x taps flops), and one
  broadcast product is a ``dot_general`` with no contraction; the port
  computes both elementwise.

The models' scans (the sLSTM loop over time, the mLSTM and SSD chunk
loops) counted by their multiplier equal the loops counted step by step,
forward and backward."""
import math
from collections import Counter

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import optim as j_optim
from repro.configs import get_smoke_config as j_smoke
from repro.core import TrainState as JTrainState
from repro.core import make_hetero_train_step as j_train_step
from repro.core import make_prefill_step as j_prefill_step
from repro.core import make_serve_step as j_serve_step
from repro.core.compression import default_tier_plans as j_plans
from repro.launch.analysis import _aval_bytes as j_aval_bytes
from repro.launch.analysis import _sub_jaxprs as j_sub_jaxprs
from repro.launch.analysis import analyze_step as j_analyze
from repro.models import get_model as j_model
from repro_torch import optim
from repro_torch.configs import get_smoke_config
from repro_torch.core.compression import default_tier_plans
from repro_torch.core.steps import (TrainState, make_fedsgd_train_step,
                                    make_hetero_train_step, make_prefill_step,
                                    make_serve_step)
from repro_torch.launch.analysis import analyze_step, trace_step
from repro_torch.launch.specs import fake_mode
from repro_torch.models import get_model, layers
from repro_torch.models.moe import capacity

B, T, TIERS = 2, 64, 4

torch.set_num_threads(1)


def _j_batch(cfg, lead, t):
    sds = jax.ShapeDtypeStruct
    b = {}
    if cfg.family == "audio":
        b["frames"] = sds((*lead, cfg.encoder_seq, cfg.d_model), jnp.float32)
    if cfg.family == "vlm":
        b["patches"] = sds((*lead, cfg.num_patches, cfg.d_model), jnp.float32)
        t -= cfg.num_patches
    b["tokens"] = sds((*lead, t), jnp.int32)
    return b


def _t_batch(cfg, lead, t):
    with fake_mode():
        b = {}
        if cfg.family == "audio":
            b["frames"] = torch.empty((*lead, cfg.encoder_seq, cfg.d_model))
        if cfg.family == "vlm":
            b["patches"] = torch.empty((*lead, cfg.num_patches, cfg.d_model))
            t -= cfg.num_patches
        b["tokens"] = torch.empty((*lead, t), dtype=torch.int32)
    return b


def _t_params(cfg):
    with fake_mode():
        return get_model(cfg).init(0, device="cpu")


def _j_matmul_traffic(jaxpr, mult: int = 1) -> int:
    """The matmul and convolution term of the reference's traffic: the
    operand and result bytes of every ``dot_general`` and
    ``conv_general_dilated`` times its enclosing scan lengths (a cond's
    costlier branch, as the reference's walk counts it)."""
    n = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in ("dot_general", "conv_general_dilated"):
            n += mult * sum(j_aval_bytes(v.aval)
                            for v in (*eqn.invars, *eqn.outvars))
        elif name == "scan":
            n += _j_matmul_traffic(eqn.params["jaxpr"].jaxpr,
                                   mult * int(eqn.params["length"]))
        elif name == "cond":
            n += max(_j_matmul_traffic(br.jaxpr, mult)
                     for br in eqn.params["branches"])
        else:
            for _, sub in j_sub_jaxprs(eqn):
                n += _j_matmul_traffic(sub, mult)
    return n


def _j_counts(step, *args) -> dict:
    counts = j_analyze(step, *args)
    counts["matmul_traffic_bytes"] = _j_matmul_traffic(
        jax.make_jaxpr(step)(*args).jaxpr)
    return counts


def _counts(arch, mode, t=T):
    """(the reference's counts, the port's) of one step at the smoke
    config: prefill of B x t tokens, decode of one token into a cache of
    t slots, or the 4-tier AdamW train step over B per tier."""
    jc, tc = j_smoke(arch), get_smoke_config(arch)
    jm, tm = j_model(jc), get_model(tc)
    if mode == "prefill":
        jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        ref = _j_counts(j_prefill_step(jm), jp, _j_batch(jc, (B,), t))
        got, _ = trace_step(make_prefill_step(tm), _t_params(tc),
                            _t_batch(tc, (B,), t))
    elif mode == "decode":
        jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        jcache = jax.eval_shape(lambda: jm.init_cache(B, t))
        ref = _j_counts(j_serve_step(jm), jp, jcache,
                        jax.ShapeDtypeStruct((B, 1), jnp.int32),
                        jax.ShapeDtypeStruct((), jnp.int32))
        with fake_mode():
            cache = tm.init_cache(B, t, device="cpu")
            tok = torch.empty((B, 1), dtype=torch.int32)
        got, _ = trace_step(make_serve_step(tm), _t_params(tc), cache, tok,
                            t - 1)
    else:
        jopt = j_optim.adamw(1e-3)
        js = jax.eval_shape(lambda k: JTrainState.create(jm, jopt, k),
                            jax.random.PRNGKey(0))
        ref = j_analyze(j_train_step(jm, jopt, j_plans(TIERS)), js,
                        _j_batch(jc, (TIERS, B), t + 1))
        opt = optim.adamw(1e-3)
        with fake_mode():
            st = TrainState.create(tm, opt, 0, device="cpu")
        got = analyze_step(make_hetero_train_step(tm, opt,
                                                  default_tier_plans(TIERS)),
                           st, _t_batch(tc, (TIERS, B), t + 1))
    return ref, got


def _flops(arch, mode, t=T):
    """(the reference's flops, the port's) of one step (:func:`_counts`)."""
    ref, got = _counts(arch, mode, t)
    return int(ref["flops"]), int(got["flops"])


def _proj(w_shape, n_rows) -> int:
    """A dense projection's flops: n_rows x d_in x d_out, times 2."""
    d = 1
    for s in w_shape:
        d *= s
    return 2 * n_rows * d


# ------------------------------------------------------------- traffic
#
# The port counts traffic by the reference's rule over ATen ops, where
# the reference counts jaxpr equations. Each helper is the reference's
# bytes minus the port's for one building block, from its shapes: f32
# at the smoke configs, bool 1 byte, int32 4, the port's int64 indices 8.

F32 = 4


def _embed_gap(n_tok: int) -> int:
    """The reference wraps negative ids (a bool compare, an int32 add and
    select) and broadcasts them for its gather; the port copies the
    int32 ids to int64 for ``embedding``."""
    return n_tok * (1 + 3 * 4 - 8)


def _proj_gap(d_in: int, out_dims: tuple, rows: int, bias: bool) -> int:
    """A weight of several output dims: the reference reshapes it to 2-D
    and the result back, where the port views. A bias: the reference
    broadcasts it before the add."""
    n_out = math.prod(out_dims)
    gap = (d_in + rows) * n_out * F32 if len(out_dims) > 1 else 0
    return gap + (n_out * F32 if bias else 0)


def _rms_gap(rows: int, d: int) -> int:
    """The mean is a sum and a div, keepdims a broadcast, and the weight
    is broadcast."""
    return 2 * rows * F32 + d * F32


def _ln_gap(rows: int, d: int) -> int:
    """Two means (a sum and a div each) with keepdims broadcasts, and the
    weight and bias broadcast."""
    return 4 * rows * F32 + 2 * d * F32


def _rope_gap(x_bytes: int, t: int, half: int) -> int:
    """The halves are slices (views in the port); the positions, the sin
    and cos tables and those again for each of the four products are
    broadcasts. The inverse frequencies' broadcast and the reference's
    one ``1 / x`` div against the port's reciprocal and mul cancel."""
    return x_bytes + t * F32 + 6 * t * half * F32


def _repeat_kv_gap(kv_bytes: int, n_rep: int) -> int:
    """The reference broadcasts k or v to (..., 1, hd) and to (..., n_rep,
    hd) and reshapes; the port expands (a view) and copies once."""
    return (1 + n_rep) * kv_bytes


def _attention_gap(b, h, t, s, hd, causal: bool) -> int:
    """One query chunk of ``chunked_attention`` (t <= q_chunk), without
    its ``repeat_kv``."""
    scores, rows = b * h * t * s * F32, b * h * t * F32
    q, kv = b * t * h * hd * F32, b * s * h * hd * F32
    return (3 * scores      # the fill's broadcast and select, softmax's
                            # sub, exp and div: 6 against the port's 3
            + 6 * rows      # softmax's max, -inf floor, stop_gradient,
                            # sum and two keepdims broadcasts
            + b * h * t * s  # the bool mask broadcast to the scores
            + 4             # the fill value's convert
            + 2 * q         # the query chunk's slice, the output's
                            # transpose
            - (q + 2 * kv)  # the port's einsums copy q, k and v
            - 4 * s - 8 * t  # int32 key and query positions against the
                             # port's int64 ones
            + (4 * s + 4 * t if causal else 0))  # their broadcasts for
                                                 # the causal compare


def _decode_attention_gap(b, h, s, hd) -> int:
    """``decode_attention`` over s slots, without its ``repeat_kv``."""
    scores, rows = b * h * s * F32, b * h * F32
    return (3 * scores + 6 * rows + b * h * s + 4
            + b * h * hd * F32             # the output's transpose
            - 2 * b * s * h * hd * F32)    # the port's einsums copy k, v


def _cross_decode_gap(b, h, s, hd) -> int:
    """``cross_attn_decode`` over s encoder rows (no mask), without its
    ``repeat_kv``: softmax as above; the output's transpose and reshape."""
    scores, rows = b * h * s * F32, b * h * F32
    return (2 * scores + 6 * rows + 2 * b * h * hd * F32
            - 2 * b * s * h * hd * F32)


def _cache_write_gap(b, s, kvh, hd) -> int:
    """The reference writes slot pos % s by a select over the whole cache:
    for k and v the slot mask broadcast twice, the new row broadcast to
    the cache and the select; for slot_pos a broadcast and a select; the
    slot index's 26 bytes of scalar equations, an iota and a compare.
    The port writes the slot's k, v and slot_pos in place."""
    cache = b * s * kvh * hd * F32
    return (26 + 4 * s + s + 2 * (s + b * s * kvh * hd + 2 * cache) + 8 * s
            - (2 * b * kvh * hd * F32 + 4))


def _sinusoid_gap(n: int, d: int) -> int:
    """The positions and frequencies broadcast for their outer product,
    and the table broadcast to (1, n, d) for the add."""
    return n * F32 + d // 2 * F32 + n * d * F32


def _traffic_gap(cfg, mode: str, b: int, t: int) -> dict:
    """The reference's traffic minus the port's, by building block, for
    ``cfg``'s prefill of b x t tokens or its decode of one token into t
    slots (dense, VLM and audio families)."""
    nl, d, h, kvh, hd = (cfg.num_layers, cfg.d_model, cfg.num_heads,
                         cfg.num_kv_heads, cfg.head_dim)
    n_rep, e, ff = h // kvh, cfg.encoder_seq, cfg.d_ff
    audio, prefill = cfg.family == "audio", mode == "prefill"
    rows = b * t if prefill else b
    kv = b * t * kvh * hd * F32          # one layer's k (or cache)
    enc_kv = b * e * kvh * hd * F32
    gap = Counter()

    def qkv(q_rows, kv_rows=None):
        """q's projection, and k's and v's unless they are cached."""
        gap["proj"] += _proj_gap(d, (h, hd), q_rows, cfg.qkv_bias)
        if kv_rows is not None:
            gap["proj"] += 2 * _proj_gap(d, (kvh, hd), kv_rows,
                                         cfg.qkv_bias)

    def mlp(n):
        if audio:
            gap["proj"] += (_proj_gap(d, (ff,), n, True)
                            + _proj_gap(ff, (d,), n, True))
            gap["gelu"] += 7 * n * ff * F32     # tanh form: 8 equations
        else:
            gap["silu"] += n * ff * F32         # logistic and mul

    text = t - cfg.num_patches if cfg.family == "vlm" else t
    gap["embed"] = _embed_gap(b * text if prefill else b)
    norm = _ln_gap if audio else _rms_gap
    if audio and prefill:                                # the encoder
        gap["positions"] += _sinusoid_gap(e, d) + 4 * e - 8 * e
        for _ in range(cfg.encoder_layers):
            gap["norm"] += 2 * _ln_gap(b * e, d)
            qkv(b * e, b * e)
            gap["repeat_kv"] += 2 * _repeat_kv_gap(enc_kv, n_rep)
            gap["attention"] += _attention_gap(b, h, e, e, hd, False)
            mlp(b * e)
        gap["norm"] += _ln_gap(b * e, d)
    if audio:
        gap["positions"] += (_sinusoid_gap(t, d) + 4 * t - 8 * t if prefill
                             else _sinusoid_gap(1, d))
    for _ in range(nl):
        gap["norm"] += (3 if audio else 2) * norm(rows, d)
        qkv(rows, rows)
        if not audio:
            gap["rope"] += (_rope_gap(rows * h * hd * F32, t if prefill
                                      else 1, hd // 2)
                            + _rope_gap(rows * kvh * hd * F32, t if prefill
                                        else 1, hd // 2))
        gap["repeat_kv"] += 2 * _repeat_kv_gap(kv, n_rep)
        if prefill:
            gap["attention"] += _attention_gap(b, h, t, t, hd, True)
        else:
            gap["cache_write"] += _cache_write_gap(b, t, kvh, hd)
            gap["attention"] += _decode_attention_gap(b, h, t, hd)
            gap["reshape"] += b * h * hd * F32   # the output's, a view
        if audio:                                # cross-attention
            qkv(rows, b * e if prefill else None)
            gap["repeat_kv"] += 2 * _repeat_kv_gap(enc_kv, n_rep)
            gap["attention"] += (_attention_gap(b, h, t, e, hd, False)
                                 if prefill
                                 else _cross_decode_gap(b, h, e, hd))
            if prefill:                          # the cache's cross-KV
                gap["proj"] += 2 * _proj_gap(d, (kvh, hd), b * e, False)
        mlp(rows)
    gap["norm"] += norm(b, d)                    # the last token's
    if prefill:
        # the reference slices the last token (a view here) and scans
        # the cache out of its layer loop, where the port stacks it; the
        # decoder's int32 positions per layer against one int64 arange
        gap["glue"] = b * d * F32 - 2 * nl * (kv + (enc_kv if audio
                                                   else 0))
        if not audio:
            gap["glue"] += nl * 4 * t - 8 * t
    return gap


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-3-2b",
                                  "deepseek-7b", "qwen2.5-32b",
                                  "llava-next-34b", "whisper-tiny"])
def test_dense_and_audio_flops_equal_reference(arch, mode):
    """Flops and the traffic's matmul term equal the reference's; the
    traffic differs by :func:`_traffic_gap`, exactly."""
    ref, got = _counts(arch, mode)
    assert got["flops"] == ref["flops"], (arch, mode, ref, got)
    assert got["matmul_traffic_bytes"] == ref["matmul_traffic_bytes"] > 0
    gap = _traffic_gap(get_smoke_config(arch), mode, B, T)
    assert ref["traffic_bytes"] - got["traffic_bytes"] \
        == sum(gap.values()), gap


def _attn_scores(b, h, t, s, hd) -> int:
    """QK^T and PV of one attention call."""
    return 2 * (2 * b * h * t * s * hd)


def test_train_flops_differ_by_the_references_remat():
    """llama3.2-3b: the reference recomputes, per tier and layer, the
    q / k / v / o and MLP wi / wg projections and the attention products
    (not wo of the MLP)."""
    arch = "llama3.2-3b"
    ref, got = _flops(arch, "train")
    cfg = get_smoke_config(arch)
    p = _t_params(cfg)
    n = B * T
    per_layer = sum(_proj(p[f"layers.{k}"].shape[1:], n) for k in (
        "attn.wq.w", "attn.wk.w", "attn.wv.w", "attn.wo.w",
        "mlp.wi.w", "mlp.wg.w"))
    per_layer += _attn_scores(B, cfg.num_heads, T, T, cfg.head_dim)
    assert ref - got == TIERS * cfg.num_layers * per_layer > 0


def test_moe_flops_differ_by_the_one_hot_einsums():
    """qwen3-moe prefill: per MoE layer the reference's dispatch and
    combine masks (token x choice x expert x slot, each a k-contraction)
    and its dispatch and combine products (x d_model)."""
    arch = "qwen3-moe-30b-a3b"
    ref, got = _flops(arch, "prefill")
    cfg = get_smoke_config(arch)
    g, n = 1, B * T                        # one group of every token
    c, e, k, d = capacity(n, cfg), cfg.num_experts, cfg.experts_per_token, \
        cfg.d_model
    per_layer = 2 * (2 * g * n * k * e * c) + 2 * (2 * g * n * e * c * d)
    assert ref - got == cfg.num_layers * per_layer > 0


def _conv(conv_w_shape) -> int:
    """The reference's depthwise causal conv over C channels of W taps:
    2 x B x T x C x W."""
    c, w = conv_w_shape[-2:]
    return 2 * B * T * c * w


def _product(heads: int, head_dim: int) -> int:
    """A broadcast product over (B, T, H, P) that the reference writes
    as a dot_general with no contraction."""
    return 2 * B * T * heads * head_dim


def test_zamba_flops_differ_by_cond_conv_and_product():
    arch = "zamba2-2.7b"
    ref, got = _flops(arch, "prefill")
    cfg = get_smoke_config(arch)
    p = _t_params(cfg)
    n = B * T
    shared = sum(_proj(p[f"shared.{k}"].shape, n) for k in (
        "attn.wq.w", "attn.wk.w", "attn.wv.w", "attn.wo.w",
        "mlp.wi.w", "mlp.wg.w", "mlp.wo.w"))
    shared += _attn_scores(B, cfg.num_heads, T, T, cfg.head_dim)
    skipped = cfg.num_layers - cfg.num_layers // cfg.attn_every
    per_mamba = (_conv(p["layers.mamba.conv_w"].shape)
                 + _product(p["layers.mamba.a_log"].shape[-1],
                            cfg.ssm_headdim))
    assert ref - got == skipped * shared + cfg.num_layers * per_mamba > 0


def test_xlstm_flops_differ_by_conv_and_product():
    arch = "xlstm-1.3b"
    ref, got = _flops(arch, "prefill")
    cfg = get_smoke_config(arch)
    p = _t_params(cfg)
    conv = p["blocks.mlstm.conv_w"]            # (superblocks, mLSTMs, C, W)
    n_mlstm = conv.shape[0] * conv.shape[1]
    per_mlstm = _conv(conv.shape) + _product(
        cfg.num_heads, conv.shape[-2] // cfg.num_heads)
    assert ref - got == n_mlstm * per_mlstm > 0


# ------------------------------------------------------------ the scans

@pytest.mark.parametrize("arch,mode,t", [("xlstm-1.3b", "prefill", 512),
                                         ("xlstm-1.3b", "prefill", 768),
                                         ("xlstm-1.3b", "train", 768),
                                         ("zamba2-2.7b", "train", 768)])
def test_scan_multiplier_equals_the_full_trace(arch, mode, t):
    """Two and three 256-chunks (T = 512, 768): xLSTM's sLSTM loop over
    T steps and (at three) its mLSTM chunks, Zamba's SSD chunks, each
    counted by the multiplier, give the flops of the loops counted step
    by step, exactly, forward and backward (one uncompressed tier,
    FedSGD); prefill's traffic exactly too."""
    cfg = get_smoke_config(arch)
    model, b = get_model(cfg), 1
    if mode == "prefill":
        step = make_prefill_step(model)
        args = (_t_params(cfg), _t_batch(cfg, (b,), t))
    else:
        opt = optim.adamw(1e-3)
        step = make_fedsgd_train_step(model, opt)
        with fake_mode():
            st = TrainState.create(model, opt, 0, device="cpu")
        args = (st, _t_batch(cfg, (b,), t + 1))
    fast, _ = trace_step(step, *args)
    full, _ = trace_step(step, *args, repeats_scans=False)
    assert fast["flops"] == full["flops"] > 0
    assert not fast["temp_exact"] and full["temp_exact"]
    if mode == "prefill":
        assert fast["traffic_bytes"] == full["traffic_bytes"]


def test_scan_outside_the_analysis_is_the_plain_loop():
    """No counter: the loop's bits (values and gradients)."""
    assert layers._scan_counter() is None
    g = torch.Generator().manual_seed(0)
    xs = torch.randn(3, 7, 5, generator=g, requires_grad=True)
    w = torch.randn(5, 5, generator=g, requires_grad=True)

    def cell(c, carry, x):
        h = torch.tanh(x[0] + carry[0] @ c[0])
        return (h,), h

    (last,), hs = layers.scan(cell, (torch.zeros(3, 5),), (xs,), (w,))
    want, h = [], torch.zeros(3, 5)
    for s in range(7):
        h = torch.tanh(xs[:, s] + h @ w)
        want.append(h)
    assert torch.equal(hs, torch.stack(want, 1)) and torch.equal(last, h)
    ga = torch.autograd.grad(hs.sum(), (xs, w))
    gb = torch.autograd.grad(torch.stack(want, 1).sum(), (xs, w))
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))


# ------------------------------------------------------------- the rule

def test_counting_rule_and_temp_bytes():
    """A matmul: 2mnk flops plus operand and result bytes; a view:
    nothing; any other op: its output bytes. The temp peak: the product
    and the sum alive together, beyond the arguments."""
    m, k, n = 8, 16, 4

    def step(x, w):
        y = x @ w                      # (m, n)
        return y.t() + 1.0

    counts, out = trace_step(step, torch.ones(m, k), torch.ones(k, n))
    assert counts["flops"] == 2 * m * k * n
    assert counts["traffic_bytes"] == 4 * (m * k + k * n + m * n) + 4 * m * n
    assert counts["temp_bytes"] == 2 * 4 * m * n and counts["temp_exact"]
    assert tuple(out.shape) == (n, m)
