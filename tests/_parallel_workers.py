"""The rank side of ``tests/test_torch_parallel*.py``: each of ``world``
processes runs this file on the CPU over gloo,

    python tests/_parallel_workers.py WORLD RANK STORE OUT EXTRA_JSON

and saves its results to ``OUT/rank{RANK}.pt`` for the test to read.
JAX-free, so the ranks import torch and the port alone (the test-side
comparisons at the end run the reference's launcher as a process of its
own). The ranks meet
through a file store, not a port, so test workers running side by side
never collide.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import named_leaves
from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.core import steps as steps_mod
from repro_torch.core.compression import (compress_with_masks, compressible,
                                          default_tier_plans,
                                          magnitude_masks)
from repro_torch.core.steps import TrainState, make_hetero_train_step
from repro_torch.data.synthetic import make_train_batch
from repro_torch.launch import specs as specs_mod
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import decoder as TD
from repro_torch.models import get_model, parallel
from repro_torch.models import layers as L
from repro_torch.models import moe as TM
from repro_torch.models.sharding import (P, NamedSharding, data_splits,
                                         gather, named, param_spec_tree,
                                         place, shard_bytes)

CPU = torch.device("cpu")
HERE = Path(__file__).resolve().parent
RANK_TIMEOUT = 240                # seconds a rank process may take
FSDP_RANK_TIMEOUT = 480           # the FSDP files' ranks: every family
DENSE = ("llama3.2-3b", "granite-3-2b", "qwen2.5-32b", "deepseek-7b")
MOE = ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b")
# the MoE, VLM and attention-fallback configs placed and gathered back,
# each at the model-parallel widths it is held at
OTHER_LAYOUTS = {2: [(n, 2) for n in (*MOE, "llava-next-34b",
                                      "llama-d-model-hd5")],
                 4: [(n, m) for n in (*MOE, "llava-next-34b")
                     for m in (2, 4)]
                 + [("llama3.2-3b", 4), ("llama-d-model", 4)]}
STEPS = 2
SHAPE = ShapeConfig("t", 16, 8, "train")


def adamw():
    """The train launcher's default optimizer: AdamW(warmup_cosine(3e-4,
    20, 100))."""
    return optim.adamw(optim.warmup_cosine(3e-4, 20, 100))


def config(name: str):
    """The smoke configs, plus: ``*-v515`` at an odd vocabulary (the
    d_model fallback of the embedding and lm_head); ``qwen-h8``, qwen's
    smoke config at 8 / 4 heads, which split 4 ways; ``granite-moe-cf1``
    at capacity factor 1, which drops choices; llama's smoke config at one
    kv head (``llama-kv1``: k / v on head_dim over 2 ranks), at 3 / 1
    heads (``llama-h3``: q on head_dim too), at 3 / 1 heads of 6
    (``llama-d-model``: q / k / v on d_model over 4 ranks, ``wo`` on its
    columns) and of 5 (``llama-d-model-hd5``: the same over 2 ranks; no
    RoPE on an odd head_dim); ``xlstm-h2`` (xLSTM's smoke config at 2
    heads) and ``zamba-hd128`` (Zamba's at Mamba2 heads of 128, 2 of
    them): at 4 ranks d_in splits but the heads do not."""
    if name.endswith("-v515"):
        return get_smoke_config(name[:-5]).replace(vocab_size=515)
    if name == "qwen-h8":
        return get_smoke_config("qwen2.5-32b").replace(
            num_heads=8, num_kv_heads=4, head_dim=16)
    if name == "granite-moe-cf1":
        return get_smoke_config("granite-moe-1b-a400m").replace(
            capacity_factor=1.0)
    if name == "llama-kv1":
        return get_smoke_config("llama3.2-3b").replace(num_kv_heads=1)
    if name == "llama-h3":
        return get_smoke_config("llama3.2-3b").replace(
            num_heads=3, num_kv_heads=1, head_dim=32)
    if name == "xlstm-h2":
        return get_smoke_config("xlstm-1.3b").replace(num_heads=2)
    if name == "xlstm-h1":
        return get_smoke_config("xlstm-1.3b").replace(num_heads=1)
    if name.startswith("whisper-enc15"):
        return get_smoke_config("whisper-tiny").replace(
            encoder_seq=15, num_kv_heads=1 if name.endswith("kv1") else 2)
    if name == "zamba-hd128":
        return get_smoke_config("zamba2-2.7b").replace(ssm_headdim=128)
    if name.startswith("llama-d-model"):
        return get_smoke_config("llama3.2-3b").replace(
            num_heads=3, num_kv_heads=1,
            head_dim=5 if name.endswith("hd5") else 6)
    return get_smoke_config(name)


def one_rank_steps(name: str) -> dict:
    """Two AdamW steps of the hetero train step in one process: the
    losses and the final params and moments."""
    cfg = config(name)
    model, opt = get_model(cfg), adamw()
    state = TrainState.create(model, opt, 0, device=CPU)
    step = make_hetero_train_step(model, opt, default_tier_plans(4))
    losses = []
    for i in range(STEPS):
        state, m = step(state, make_train_batch(cfg, SHAPE, n_tiers=4,
                                                seed=3, index=i))
        losses.append(m["loss"].item())
    return {"losses": losses, "params": state["params"],
            "m": state["opt"]["m"], "v": state["opt"]["v"]}


def _mesh_steps(name: str, mp: int) -> dict:
    """:func:`one_rank_steps` on the (world / mp, mp) mesh of ranks: the
    losses, the collectives the last step counted
    (``parallel.counting``), and the params and moments gathered."""
    cfg = config(name)
    model, opt = get_model(cfg), adamw()
    mesh = make_host_mesh(mp, devices=[CPU])
    state = TrainState.create(model, opt, 0, device=CPU)
    sh = named(mesh, param_spec_tree(state, mesh.shape["model"]))
    state = place(state, sh)
    step = make_hetero_train_step(model, opt, default_tier_plans(4),
                                  shardings=sh["params"])
    losses = []
    with parallel.using(mesh):
        for i in range(STEPS):
            with parallel.counting() as census:
                state, m = step(state, make_train_batch(
                    cfg, SHAPE, n_tiers=4, seed=3, index=i))
            losses.append(m["loss"].item())
    return {"losses": losses, "census": census.record(),
            **{k: gather(v, sh["params"]) for k, v in (
                ("params", state["params"]), ("m", state["opt"]["m"]),
                ("v", state["opt"]["v"]))}}


def bf16_step(arch: str, ckpt_dir: str) -> dict:
    """One hetero train step (the launcher's AdamW, 4 tiers, 8 x 16, batch
    index 0) of ``arch``'s smoke config in bf16 from the reference's init
    checkpoint in ``ckpt_dir`` (``tests/_reference_bf16_step.py``) on the
    (1, world) mesh of ranks: its loss and AdamW's first moment after it,
    gathered."""
    cfg = get_smoke_config(arch).replace(dtype="bfloat16")
    model, opt = get_model(cfg), adamw()
    mesh = make_host_mesh(dist.get_world_size(), devices=[CPU])
    state = TrainState.create(model, opt, 0, device=CPU)
    sh = named(mesh, param_spec_tree(state, mesh.shape["model"]))
    state, _ = Checkpointer(ckpt_dir).restore(place(state, sh),
                                              shardings=sh)
    step = make_hetero_train_step(model, opt, default_tier_plans(4),
                                  shardings=sh["params"])
    batch = make_train_batch(cfg, ShapeConfig("cli", 16, 8, "train"),
                             n_tiers=4, seed=0, index=0)
    with parallel.using(mesh):
        state, metrics = step(state, batch)
    return {"loss": metrics["loss"].item(),
            "m": gather(state["opt"]["m"], sh["params"])}


# ------------------------------------------------------------------ layers

def _blocks(p: dict, dims: dict) -> dict:
    """This rank's block of each leaf along its dim (None: whole)."""
    return {k: v if dims.get(k) is None else parallel.block(v, "model",
                                                            dims[k])
            for k, v in p.items()}


def _run(fn, p: dict, x: torch.Tensor, dims: dict, mesh=None):
    """(fn's output, its gradients w.r.t. ``p`` made whole and w.r.t.
    ``x``) for the loss ``sum(out * w)`` with a fixed random ``w``; with
    ``mesh`` the leaves are this rank's blocks."""
    with parallel.using(mesh):
        leaves = {k: v.clone().requires_grad_() for k, v in
                  (_blocks(p, dims) if mesh else p).items()}
        xg = x.clone().requires_grad_()
        out = fn(leaves, xg)
        w = torch.randn(out.shape, generator=torch.Generator().manual_seed(9),
                        dtype=out.dtype)
        grads = torch.autograd.grad((out * w).sum(), [*leaves.values(), xg])
        whole = {k: g if mesh is None or dims.get(k) is None
                 else parallel.all_gather(g, "model", dims[k])
                 for k, g in zip(leaves, grads)}
    return out.detach(), whole, grads[-1]


def _run_rows(fn, p: dict, x: torch.Tensor, dims: dict, mesh) -> tuple:
    """:func:`_run` on ``mesh``, whose "data" ranks take their rows of
    ``x`` (dim 0), as the train step gives them: each rank's loss is
    ``dp * sum(out * w)`` over its rows plus the last (replicated) entry
    of ``out`` times its weight (the MoE aux), whose mean over "data" is
    the one-rank loss; the gradients are the step's, the mean over
    "data", made whole; the output and the input's gradient (over dp)
    gathered over "data"."""
    dp = mesh.shape["data"]
    with parallel.using(mesh):
        leaves = {k: v.clone().requires_grad_()
                  for k, v in _blocks(p, dims).items()}
        xg = parallel.block(x, "data", 0).clone().requires_grad_()
        out = fn(leaves, xg)
        w = torch.randn((x.shape[0] * (out.numel() - 1) // xg.shape[0] + 1,),
                        generator=torch.Generator().manual_seed(9))
        rows = parallel.block(w[:-1], "data", 0)
        loss = dp * (out[:-1] * rows).sum() + out[-1] * w[-1]
        grads = torch.autograd.grad(loss, [*leaves.values(), xg])
        whole = {}
        for k, g in zip(leaves, grads):
            g = parallel.all_reduce(g, "data") / dp
            whole[k] = (g if dims.get(k) is None
                        else parallel.all_gather(g, "model", dims[k]))
        body = parallel.all_gather(out[:-1].detach(), "data", 0)
        gx = parallel.all_gather(grads[-1], "data", 0) / dp
    return torch.cat([body, out[-1:].detach()]), whole, gx


def _one_rank_rows(fn, p: dict, x: torch.Tensor) -> tuple:
    """:func:`_run_rows`'s loss in one process."""
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    xg = x.clone().requires_grad_()
    out = fn(leaves, xg)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(9))
    grads = torch.autograd.grad((out * w).sum(), [*leaves.values(), xg])
    return out.detach(), dict(zip(leaves, grads)), grads[-1]


def _attn_case(name: str, world: int, seed: int):
    """(cfg, q / k / v / wo params with random biases, the blocks' dims)
    of an attention fallback config: ``wq`` on heads or its layout's dim,
    as ``param_spec_tree`` puts it at ``world`` model shards."""
    cfg = config(name)
    gen = torch.Generator().manual_seed(seed)
    p = L.init_attn(gen, cfg.replace(qkv_bias=True))
    for k in ("wq.b", "wk.b", "wv.b"):
        p[k] = torch.randn(p[k].shape, generator=gen) * 0.1
    specs = param_spec_tree({"attn." + k: v for k, v in p.items()}, world)
    dims = {k: next((d - len(specs["attn." + k]) for d, e in
                     enumerate(specs["attn." + k]) if e is not None), None)
            for k in p}
    return cfg, p, dims


def _other_layer_cases(world: int) -> dict:
    """The MoE layer, attention's head_dim and d_model fallbacks and the
    VLM projector at mesh (1, world), and the MoE layer with the batch's
    rows over "data" ((world, 1), and (2, 2) at 4 ranks), each against
    one rank on the same inputs."""
    gen = torch.Generator().manual_seed(1)
    cases = {}
    mesh = make_host_mesh(world, devices=[CPU])
    # MoE at capacity factor 1 (choices dropped), output and aux
    cfg = config("granite-moe-cf1")
    moe = TM.init_moe(gen, cfg)
    experts = {"we_g": 0, "we_i": 0, "we_o": 0}
    x = torch.randn((4, 8, cfg.d_model), generator=gen)

    def moe_fn(p, x):
        y, aux = TM.moe_apply(p, x, cfg, split=p["we_g"].shape[0]
                              != cfg.num_experts)
        return torch.cat([y.reshape(-1), aux[None]])
    cases["moe_apply"] = (_run(moe_fn, moe, x, experts, mesh),
                          _run(moe_fn, moe, x, experts))
    one = _one_rank_rows(moe_fn, moe, x)
    for mp in ((1,) if world == 2 else (1, 2)):
        m = make_host_mesh(mp, devices=[CPU])
        cases[f"moe_apply_rows_{world // mp}x{mp}"] = (
            _run_rows(moe_fn, moe, x, experts if mp > 1 else {}, m), one)
    # attention: q on heads, k / v on head_dim (llama's smoke config at
    # 4 ranks; at 2, one kv head); q and k / v on head_dim (3 / 1 heads);
    # q / k / v on d_model and wo on its columns
    xa = torch.randn((2, 8, 128), generator=gen)
    for case, name, kw in (
            ("attn_head_dim", "llama3.2-3b" if world == 4 else "llama-kv1",
             {"use_flash": True}),
            ("attn_head_dim_q", "llama-h3", {}),
            ("attn_d_model", "llama-d-model" if world == 4
             else "llama-d-model-hd5", {})):
        acfg, p, dims = _attn_case(name, world, 2)
        acfg = acfg.replace(**kw)
        rope = acfg.head_dim % 2 == 0

        def attn_fn(p, x, acfg=acfg, rope=rope):
            return L.attn_forward(p, x, acfg, use_rope=rope)
        cases[case] = (_run(attn_fn, p, xa, dims, mesh),
                       _run(attn_fn, p, xa, dims))
    # the projected patches, in front of the text embeddings
    vcfg = config("llava-next-34b")
    vp = {"embed": L.init_embed(gen, vcfg.vocab_size, vcfg.d_model),
          "projector.w": torch.randn((vcfg.d_model, vcfg.d_model),
                                     generator=gen) * 0.05}
    tokens = torch.randint(0, vcfg.vocab_size, (2, 8), generator=gen)
    patches = torch.randn((2, vcfg.num_patches, vcfg.d_model), generator=gen)

    def vlm_fn(p, x):
        return TD._embed_inputs(p, tokens, vcfg, x)
    vdims = {"embed": 0, "projector.w": -1}
    cases["projector"] = (_run(vlm_fn, vp, patches, vdims, mesh),
                          _run(vlm_fn, vp, patches, vdims))
    if world == 2:
        # the prefill's attention with q on head_dim (3 heads over 2
        # ranks) at T = 2048: each rank attends with its 1024 query rows,
        # one of the one-rank run's two chunks; ``wo`` whole, so that y is
        # the attention's own output through one whole product
        pcfg, pp, pdims = _attn_case("llama-h3", world, 3)
        pdims["wo.w"] = None
        xp = torch.randn((1, 2048, pcfg.d_model),
                         generator=torch.Generator().manual_seed(7))
        with torch.no_grad():
            with parallel.using(mesh):
                mine = L.attn_prefill(_blocks(pp, pdims), xp, pcfg)
            cases["attn_prefill_rows"] = (mine, L.attn_prefill(pp, xp, pcfg))
    return cases


def _layer_cases(world: int) -> dict:
    """Each layer at mesh (1, world) against one rank on the same inputs:
    (the split run, the one-rank run), each (output, whole gradients,
    the input's gradient)."""
    gen = torch.Generator().manual_seed(0)
    cfg = config("qwen-h8")                   # biased q/k/v, 8 / 4 heads
    d = cfg.d_model
    x = torch.randn((2, 8, d), generator=gen)
    attn = L.init_attn(gen, cfg)
    for k in ("wq.b", "wk.b", "wv.b"):
        attn[k] = torch.randn(attn[k].shape, generator=gen) * 0.1
    heads = {k: -2 for k in ("wq.w", "wq.b", "wk.w", "wk.b", "wv.w",
                             "wv.b")} | {"wo.w": 0}
    mlp = L.init_swiglu(gen, d, cfg.d_ff)
    cols = {"wi.w": -1, "wg.w": -1, "wo.w": 0}
    table_v = L.init_embed(gen, 512, d)       # the model's own scale
    table_d = L.init_embed(gen, 515, d)
    tokens = torch.randint(0, 512, (2, 8), generator=gen)
    tokens_d = torch.randint(0, 515, (2, 8), generator=gen)
    labels = torch.randint(0, 512, (2, 8), generator=gen)
    logits = torch.randn((2, 8, 512), generator=gen) * 3

    cases = {
        "attn_forward": (lambda p, x: L.attn_forward(p, x, cfg), attn, x,
                         heads),
        "attn_forward_flash": (
            lambda p, x: L.attn_forward(p, x, cfg.replace(use_flash=True)),
            attn, x, heads),
        "swiglu": (lambda p, x: L.swiglu(p, x, split=p["wi.w"].shape[-1]
                                         != cfg.d_ff), mlp, x, cols),
        "embed_vocab": (lambda p, x: L.embed(
            p["t"], tokens, torch.float32,
            L.VOCAB if p["t"].shape[0] != 512 else None) * x,
            {"t": table_v}, x, {"t": 0}),
        "embed_d_model": (lambda p, x: L.embed(
            p["t"], tokens_d, torch.float32,
            L.D_MODEL if p["t"].shape[1] != d else None) * x,
            {"t": table_d}, x, {"t": 1}),
        "unembed_vocab": (lambda p, x: parallel.gather_from_model(L.unembed(
            x, p["t"], L.VOCAB if p["t"].shape[0] != 512 else None), -1),
            {"t": table_v}, x, {"t": 0}),
        "unembed_d_model": (lambda p, x: L.unembed(
            x, p["t"], L.D_MODEL if p["t"].shape[1] != d else None),
            {"t": table_d}, x, {"t": 1}),
        "cross_entropy_vocab": (lambda p, x: L.cross_entropy(
            p["z"], labels, vocab_split=p["z"].shape[-1] != 512)[None]
            + 0 * x.sum(), {"z": logits}, x, {"z": -1}),
        "vocab_chain": (lambda p, x: L.cross_entropy(L.unembed(
            L.embed(p["t"], tokens, torch.float32,
                    L.VOCAB if p["t"].shape[0] != 512 else None) + x,
            p["t"], L.VOCAB if p["t"].shape[0] != 512 else None), labels,
            vocab_split=p["t"].shape[0] != 512)[None],
            {"t": table_v}, x, {"t": 0}),
    }
    mesh = make_host_mesh(world, devices=[CPU])
    return {**{name: (_run(fn, p, xx, dims, mesh), _run(fn, p, xx, dims))
               for name, (fn, p, xx, dims) in cases.items()},
            **_other_layer_cases(world)}


# --------------------------------------------------------- place / masks

def _round_trips(pairs) -> dict:
    """For each (config, model shards) of ``pairs``: the specs, and
    whether every placed leaf is the block of the whole one, gathers back
    bitwise, and the bytes equal ``shard_bytes``."""
    out = {}
    for name, mp in pairs:
        mesh = make_host_mesh(mp, devices=[CPU])
        cfg = config(name)
        model, opt = get_model(cfg), optim.adamw(1e-3)
        state = TrainState.create(model, opt, 0, device=CPU)
        specs = param_spec_tree(state, mesh.shape["model"])
        sh = named(mesh, specs)
        placed = place(state, sh)
        back = gather(placed, sh)
        blocks = all(torch.equal(placed["params"][k], sh["params"][k]
                                 .block(v)) for k, v in
                     state["params"].items())
        same = all(torch.equal(back[g][k], state[g][k])
                   for g in ("params",) for k in state[g]) and all(
            torch.equal(back["opt"][m][k], state["opt"][m][k])
            for m in ("m", "v") for k in state["params"])
        local = sum(t.numel() * t.element_size()
                    for t in (*placed["params"].values(),
                              *placed["opt"]["m"].values(),
                              *placed["opt"]["v"].values(),
                              placed["opt"]["count"], placed["step"]))
        out[name if mp == 2 else f"{name} {mp}"] = {
                     "specs": {k: tuple(v) for k, v in specs["params"]
                               .items()},
                     "blocks": blocks, "gathered": same,
                     "bytes": (local, shard_bytes(state, sh))}
    return out


def _mask_leaves() -> tuple[dict, dict]:
    """Leaves with repeated magnitudes (ties at the threshold), small ones
    that share a bisection and one past ``pruning.SMALL``, and their
    specs over "model" (None: replicated)."""
    gen = torch.Generator().manual_seed(5)
    ws = {"a": torch.randn((64, 48), generator=gen),
          "b": torch.randint(-6, 7, (8, 320), generator=gen).float() * 0.5,
          "c": torch.randn((320, 256), generator=gen),
          "d": torch.randn((4, 16, 8), generator=gen),
          "r": torch.randn((16, 16), generator=gen)}
    specs = {"a": P("model", None), "b": P(None, "model"),
             "c": P(None, "model"), "d": P(None, None, "model"),
             "r": P(None, None)}
    return ws, specs


def _masks(world: int) -> dict:
    """``magnitude_masks(shardings=)`` at mesh (1, world) and the one-rank
    masks' blocks, per density; and ``compress_with_masks`` of a whole
    model (pruned, then fp8 e5m2 or int8, whose per-tensor scale is the
    whole leaf's) against one rank's blocks: qwen-h8 (heads), the MoE
    configs (experts), an attention fallback (d_model at 4 ranks,
    head_dim at 2) and llama's head_dim fallback (heads at 2)."""
    mesh = make_host_mesh(world, devices=[CPU])
    ws, specs = _mask_leaves()
    sh = {k: NamedSharding(mesh, s) for k, s in specs.items()}
    out = {}
    for density in (0.5, 0.25, 0.1):
        whole = magnitude_masks(ws, density)
        local = magnitude_masks({k: sh[k].block(w) for k, w in ws.items()},
                                density, shardings=sh)
        out[f"masks_{density}"] = (local, {k: sh[k].block(m)
                                           for k, m in whole.items()})
    for label, name, e, m_bits in (
            ("fp8", "qwen-h8", 5, 2), ("int8", "qwen-h8", 0, 8),
            ("moe_fp8", "granite-moe-1b-a400m", 5, 2),
            ("moe_int8", "qwen3-moe-30b-a3b", 0, 8),
            ("attn_fallback_fp8", "llama-d-model" if world == 4
             else "llama-d-model-hd5", 5, 2),
            ("head_dim_int8", "llama3.2-3b" if world == 4
             else "llama-kv1", 0, 8)):
        params = get_model(config(name)).init(0, device=CPU)
        psh = named(mesh, param_spec_tree(params, world))
        cp, m = compress_with_masks(params, 0.25, e, m_bits)
        with parallel.using(mesh):
            lcp, lm = compress_with_masks(place(params, psh), 0.25, e,
                                          m_bits, shardings=psh)
        out[f"compress_with_masks_{label}"] = (
            {**lcp, **{"mask/" + k: v for k, v in lm.items()}},
            {**{k: psh[k].block(v) for k, v in cp.items()},
             **{"mask/" + k: (psh[k].block(v) if v.dim() else v)
                for k, v in m.items()}})
    return out


def family_batch(cfg) -> dict:
    """A seeded (2, 9) token batch, with (2, P, D) patches for VLM and
    (2, S_enc, D) frames for audio."""
    gen = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 9),
                                     generator=gen)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((2, cfg.num_patches, cfg.d_model),
                                       generator=gen)
    if cfg.family == "audio":
        batch["frames"] = torch.randn((2, cfg.encoder_seq, cfg.d_model),
                                      generator=gen)
    return batch


FAMILIES = ("granite-moe-1b-a400m", "llava-next-34b", "xlstm-1.3b",
            "zamba2-2.7b", "whisper-tiny")
RECURRENT = ("xlstm-1.3b", "zamba2-2.7b", "whisper-tiny")


def _family_losses(world: int) -> dict:
    """Each family's ``loss_fn`` on each rank's blocks at mesh (1, world)
    (the MoE and VLM decoders, xLSTM, Zamba and Whisper)."""
    mesh = make_host_mesh(world, devices=[CPU])
    out = {}
    for arch in FAMILIES:
        cfg = config(arch)
        model = get_model(cfg)
        params = model.init(0, device=CPU)
        placed = place(params, named(mesh, param_spec_tree(params, world)))
        with parallel.using(mesh):
            out[arch] = {"loss": model.loss_fn(placed,
                                               family_batch(cfg)).item()}
    return out


# ------------------------------------------- prefill and decode over ranks

SERVE_ARCHS = ("llama3.2-3b", *FAMILIES)
SERVE_B, SERVE_T, SERVE_STEPS = 4, 8, 3
# the model-parallel widths of each world's meshes: (1, 2) and (2, 1) on
# 2 ranks, (2, 2) and (1, 4) on 4
SERVE_MPS = {2: (2, 1), 4: (2, 4)}


def serve_shapes(t: int = SERVE_T, b: int = SERVE_B) -> tuple:
    """The prefill shape (b x t, a VLM's patches among the t) and the
    decode shape (one token into the prefill's t slots) of
    :func:`serve_run`, as ``launch.specs``'s setups take them."""
    return (ShapeConfig("p", t, b, "prefill"),
            ShapeConfig("d", t, b, "decode"))


def serve_inputs(cfg, t: int = SERVE_T, b: int = SERVE_B,
                 seed: int = 5) -> tuple[dict, list]:
    """A seeded prefill batch of ``serve_shapes(t, b)`` (tokens, and
    patches for VLM or frames for audio) and ``SERVE_STEPS`` decode
    tokens (b, 1), drawn with numpy."""
    rng = np.random.default_rng(seed)
    text = t - (cfg.num_patches if cfg.family == "vlm" else 0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, text), dtype=np.int32))}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model), dtype=np.float32))
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model), dtype=np.float32))
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1),
                                          dtype=np.int32))
            for _ in range(SERVE_STEPS)]
    return batch, toks


def _clone(tree):
    return ({k: _clone(v) for k, v in tree.items()}
            if isinstance(tree, dict) else tree.clone())


def serve_run(cfg, params: dict, batch: dict, toks: list, mesh=None,
              dp: int = 1) -> dict:
    """``launch.specs``'s prefill step, then a decode step per token of
    ``toks`` (positions T, T + 1, ...), ``num_groups`` ``dp`` as the
    setups thread it; with ``mesh`` (of ranks) on this rank's blocks of
    ``params`` (placed by ``param_spec_tree``), the steps inside
    ``parallel.using`` it: each call's logits, the cache after the
    prefill and after the last step, and the collectives each call
    counted."""
    from repro_torch.core.steps import make_prefill_step, make_serve_step
    model = get_model(cfg)
    prefill = make_prefill_step(model, num_groups=dp)
    decode = make_serve_step(model, num_groups=dp)
    t = next(iter(batch.values())).shape[1] + (
        cfg.num_patches if cfg.family == "vlm" else 0)
    if mesh is not None:
        params = place(params, named(mesh, param_spec_tree(
            params, mesh.shape["model"])))
    out = {"logits": [], "census": []}
    with parallel.using(mesh):
        with parallel.counting() as c:
            logits, cache = prefill(params, batch)
        out["logits"].append(logits)
        out["census"].append(c.record())
        out["prefill_cache"] = _clone(cache)
        for i, tok in enumerate(toks):
            with parallel.counting() as c:
                logits, cache = decode(params, cache, tok, t + i)
            out["logits"].append(logits)
            out["census"].append(c.record())
    out["cache"] = cache
    return out


# 2-rank runs whose layouts fall back, (config, prompt, rows, model
# ranks): on (1, 2) a prompt of 9 (odd) puts a self-attention cache on its
# 2 kv heads, or with one kv head on head_dim; the xLSTM states of one
# head go on their last dim (the mLSTM cell on its block of dk), over one
# chunk or three; Whisper's 15 encoder frames put the cross-KV on its kv
# heads, or with one kv head on head_dim; with 3 heads q falls back to
# head_dim and the prefill splits its query rows (8, or 9: the last
# rank's block short); on (2, 1) 3 rows do not split over the 2 data
# ranks, so each holds the whole batch (the MoE layer then groups it
# whole)
SERVE_FALLBACKS = {"kv heads": ("llama3.2-3b", 9, SERVE_B, 2),
                   "head_dim": ("llama-kv1", 9, SERVE_B, 2),
                   "xlstm last dim": ("xlstm-h1", 8, SERVE_B, 2),
                   "xlstm chunks": ("xlstm-h1", 3 * 256, SERVE_B, 2),
                   "cross kv heads": ("whisper-enc15", 8, SERVE_B, 2),
                   "cross head_dim": ("whisper-enc15-kv1", 8, SERVE_B, 2),
                   "q head_dim": ("llama-h3", 8, SERVE_B, 2),
                   "q head_dim odd": ("llama-h3", 9, SERVE_B, 2),
                   "rows whole": ("granite-moe-1b-a400m", 8, 3, 1)}


def _serve_runs(world: int) -> dict:
    """:func:`serve_run` of every family (:data:`SERVE_ARCHS`) on each
    mesh of :data:`SERVE_MPS` of ``world`` ranks, from each config's
    seed-0 params and :func:`serve_inputs`; on 2 ranks also the
    :data:`SERVE_FALLBACKS`."""
    out = {}
    if world == 2:
        for case, (name, t, b, mp) in SERVE_FALLBACKS.items():
            cfg = config(name)
            mesh = make_host_mesh(mp, devices=[CPU])
            out[case] = serve_run(cfg, get_model(cfg).init(0, device=CPU),
                                  *serve_inputs(cfg, t, b), mesh,
                                  mesh.shape["data"])
    for arch in SERVE_ARCHS:
        cfg = config(arch)
        params = get_model(cfg).init(0, device=CPU)
        batch, toks = serve_inputs(cfg)
        for mp in SERVE_MPS[world]:
            mesh = make_host_mesh(mp, devices=[CPU])
            out[f"{arch} {mp}"] = serve_run(cfg, params, batch, toks, mesh,
                                            mesh.shape["data"])
    return out


def reference_serve(arch: str, ref_dir: str) -> dict:
    """:func:`serve_run` of ``arch``'s smoke config from the reference's
    deployed params (``tests/_reference_serve_step.py``'s checkpoint in
    ``ref_dir``) on its inputs, on the (world / M, M) mesh of ranks for
    each M of its meshes."""
    cfg = get_smoke_config(arch)
    params, _ = Checkpointer(ref_dir).restore(
        get_model(cfg).init(0, device=CPU), 0)
    with np.load(os.path.join(ref_dir, "inputs.npz")) as z:
        batch = {k[6:]: torch.from_numpy(z[k]) for k in z.files
                 if k.startswith("batch/")}
        toks = [torch.from_numpy(z[f"toks/{i}"]) for i in range(
            sum(k.startswith("toks/") for k in z.files))]
    out = {}
    for mp in (2, 4):
        mesh = make_host_mesh(mp, devices=[CPU])
        out[mp] = serve_run(cfg, params, batch, toks, mesh,
                            mesh.shape["data"])
    return out


# ------------------------------------ xLSTM, Zamba and Whisper over ranks

def _specs_dims(p: dict, prefix: str, world: int) -> dict:
    """The dim (from the end) of each leaf of ``p`` that
    ``param_spec_tree`` splits over ``world`` model shards, the leaf
    named ``prefix + name`` (None: whole)."""
    specs = param_spec_tree({prefix + k: v for k, v in p.items()}, world)
    return {k: next((d - len(specs[prefix + k]) for d, e in
                     enumerate(specs[prefix + k]) if e is not None), None)
            for k in p}


def _jitter(p: dict, gen, names) -> dict:
    """``p`` with the leaves ``names`` (ones, zeros or linspaces at init)
    moved by seeded noise, so that their gradients test the layout."""
    return {k: v + 0.1 * torch.randn(v.shape, generator=gen)
            if k in names else v for k, v in p.items()}


def _recurrent_layer_cases(world: int) -> dict:
    """``mamba_forward``, ``mlstm_forward``, ``slstm_forward`` and
    ``gelu_mlp(split=True)`` at mesh (1, world) against one rank on the
    same inputs, each leaf split as ``param_spec_tree`` splits it; at 4
    ranks also the layouts whose heads do not split (``xlstm-h2``,
    ``zamba-hd128``)."""
    from repro_torch.models import mamba2 as TMB
    from repro_torch.models import xlstm as TX
    gen = torch.Generator().manual_seed(6)
    mesh = make_host_mesh(world, devices=[CPU])
    names = [("mamba", "zamba2-2.7b"), ("mlstm", "xlstm-1.3b"),
             ("slstm", "xlstm-1.3b"), ("gelu_mlp", "whisper-tiny")]
    if world == 4:
        names += [("mamba", "zamba-hd128"), ("mlstm", "xlstm-h2"),
                  ("slstm", "xlstm-h2")]
    cases = {}
    for kind, name in names:
        cfg = config(name)
        x = torch.randn((2, 16, cfg.d_model), generator=gen)
        if kind == "mamba":
            p = _jitter(TMB.init_mamba(gen, cfg), gen, (
                "a_log", "conv_b", "d_skip", "dt_bias", "gate_norm"))

            def fn(p, x, cfg=cfg):
                return TMB.mamba_forward(p, x, cfg)[0]
        elif kind == "mlstm":
            p = _jitter(TX.init_mlstm(gen, cfg), gen, (
                "ln", "conv_b", "gates.b", "mnorm", "skip"))

            def fn(p, x, cfg=cfg):
                return TX.mlstm_forward(p, x, cfg)[0]
        elif kind == "slstm":
            p = _jitter(TX.init_slstm(gen, cfg), gen, (
                "ln", "gates_x.b", "gnorm"))

            def fn(p, x, cfg=cfg):
                return TX.slstm_forward(p, x, cfg)[0]
        else:
            p = _jitter(L.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff), gen,
                        ("wi.b", "wo.b"))

            def fn(p, x, cfg=cfg):
                return L.gelu_mlp(p, x, split=p["wi.w"].shape[-1]
                                  != cfg.d_ff)
        dims = _specs_dims(p, f"{'mlp' if kind == 'gelu_mlp' else kind}/",
                           world)
        key = kind if name in RECURRENT else f"{kind} {name}"
        cases[key] = (_run(fn, p, x, dims, mesh), _run(fn, p, x, dims),
                      {k: d for k, d in dims.items() if d is not None},
                      _run_f64(fn, p, x))
    return cases


def _run_f64(fn, p: dict, x: torch.Tensor) -> tuple:
    """:func:`_run` in one process with the leaves, the input and the
    contraction's weights (drawn in f32) in f64: the answer both f32 runs
    are held to (the norms still compute in f32)."""
    leaves = {k: v.double().requires_grad_() for k, v in p.items()}
    xg = x.double().requires_grad_()
    out = fn(leaves, xg)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(9))
    grads = torch.autograd.grad((out * w.double()).sum(),
                                [*leaves.values(), xg])
    return out.detach(), dict(zip(leaves, grads)), grads[-1]


def _family_masks(world: int) -> dict:
    """``compress_with_masks`` (pruned at 0.25, then fp8 e5m2 or int8 at
    the whole leaf's scale) of each recurrent family's smoke params on
    each rank's blocks at mesh (1, world) and the one-rank result's
    blocks."""
    mesh = make_host_mesh(world, devices=[CPU])
    out = {}
    for name in RECURRENT:
        params = get_model(config(name)).init(0, device=CPU)
        psh = named(mesh, param_spec_tree(params, world))
        for label, e, m_bits in (("fp8", 5, 2), ("int8", 0, 8)):
            cp, m = compress_with_masks(params, 0.25, e, m_bits)
            with parallel.using(mesh):
                lcp, lm = compress_with_masks(place(params, psh), 0.25, e,
                                              m_bits, shardings=psh)
            out[f"{name} {label}"] = (
                {**lcp, **{"mask/" + k: v for k, v in lm.items()}},
                {**{k: psh[k].block(v) for k, v in cp.items()},
                 **{"mask/" + k: (psh[k].block(v) if v.dim() else v)
                    for k, v in m.items()}})
    return out


def _bf16_sums(world: int) -> dict:
    """The sums over "model" of each rank's seeded bf16 partials (4096
    values a rank, at scales 2^-8..2^8) at mesh (1, world): forward,
    ``reduce_from_model`` of them; backward, the gradient that
    ``copy_to_model`` and ``gather_to_ranks`` give a bf16 input when each
    rank's output gradient is its partials. With every rank's partials
    (drawn here from their seeds) and the old arithmetic: the partials
    all-reduced in bf16 through gloo, each addition rounded."""
    parts = []
    for r in range(world):
        gen = torch.Generator().manual_seed(100 + r)
        scale = 2.0 ** torch.randint(-8, 9, (4096,), generator=gen)
        parts.append((torch.randn((4096,), generator=gen)
                      * scale).to(torch.bfloat16))
    mesh = make_host_mesh(world, devices=[CPU])
    mine = parts[dist.get_rank()]
    x = torch.zeros_like(mine, requires_grad=True)
    xs = torch.zeros_like(mine[:4096 // world], requires_grad=True)
    with parallel.using(mesh):
        got = parallel.reduce_from_model(mine)
        parallel.copy_to_model(x).backward(mine)
        parallel.gather_to_ranks(xs, -1).backward(mine)
    old = mine.clone()
    dist.all_reduce(old)
    return {"forward": got, "backward": x.grad, "gather_to_ranks": xs.grad,
            "parts": parts, "old": old}


def run_recurrent(world: int, extra: dict) -> dict:
    """Every rank-side check of ``tests/test_torch_parallel_recurrent.py``
    for ``world`` ranks."""
    return {"bf16_sums": _bf16_sums(world),
            "layers": _recurrent_layer_cases(world),
            "masks": _family_masks(world),
            "round_trips": _round_trips([(n, m) for n in RECURRENT
                                         for m in sorted({2, world})]),
            "steps": {f"{name} {mp}": _mesh_steps(name, mp)
                      for name, mp in extra["steps"]}}


# ------------------------------------------------- FSDP (data-axis blocks)

FSDP_FAMILIES = ("llama3.2-3b", "granite-moe-1b-a400m", "llava-next-34b",
                 "whisper-tiny", "zamba2-2.7b", "xlstm-1.3b")
FSDP_STEPS = 3
FSDP_SHAPE = ShapeConfig("fsdp", 16, 8, "train")


def fsdp_specs(tree, mesh, fsdp: bool = True) -> dict:
    """``param_spec_tree(tree, M, fsdp=(("data",), D))`` on ``mesh``'s
    (D, M), as the reference's dry run lays out its train state; without
    ``fsdp`` the "model" layout alone."""
    return named(mesh, param_spec_tree(
        tree, mesh.shape["model"],
        (("data",), mesh.shape["data"]) if fsdp else None))


def fsdp_meshes(world: int) -> list[int]:
    """The model-parallel widths of the FSDP meshes at ``world`` ranks:
    (2, 1) at 2; (4, 1) and (2, 2) at 4."""
    return [1] if world == 2 else [1, 2]


def fsdp_step_mesh(world: int) -> int:
    """The model-parallel width of the mesh the steps run on at ``world``
    ranks: (2, 1) at 2, (2, 2) at 4 (at (4, 1) the 2 rows a tier of
    :data:`FSDP_SHAPE` do not split over the data ranks)."""
    return 1 if world == 2 else 2


def _fsdp_round_trips(world: int) -> dict:
    """Each family's train state placed FSDP on each mesh and gathered
    back: whether every placed leaf is the block of the whole one, the
    state gathers back bitwise, the placed bytes == ``shard_bytes``, and
    how many params leaves have a data-axis entry."""
    out = {}
    for mp in fsdp_meshes(world):
        mesh = make_host_mesh(mp, devices=[CPU])
        for name in FSDP_FAMILIES:
            state = TrainState.create(get_model(config(name)), adamw(), 0,
                                      device=CPU)
            sh = fsdp_specs(state, mesh)
            placed = place(state, sh)
            back = gather(placed, sh)
            whole, local = _tensors(state), _tensors(placed)
            out[f"{name} {mp}"] = {
                "blocks": all(torch.equal(placed["params"][k],
                                          sh["params"][k].block(v))
                              for k, v in state["params"].items()),
                "gathered": all(torch.equal(a, b) for a, b in
                                zip(_tensors(back), whole)),
                "bytes": (sum(t.numel() * t.element_size() for t in local),
                          shard_bytes(state, sh)),
                "data_split": sum("data" in s.spec
                                  for s in sh["params"].values())}
    return out


def _fsdp_gathers(world: int) -> dict:
    """``parallel.gather_blocks`` of a seeded tensor's blocks along each
    dim over "data" at mesh (world, 1), f32 and bf16: its output, and the
    gradient of its block when each rank's gradient of the whole is
    drawn from the rank's seed; with every rank's gradients, for the test
    to sum. And the same product with and without ``regathering``: the
    gradients, and whether the whole leaf is still alive after the
    forward."""
    mesh = make_host_mesh(1, devices=[CPU])
    rank = dist.get_rank()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((8, 12, 4), generator=torch.Generator().manual_seed(
            1)).to(dtype)
        for dim in range(3):
            gs = [torch.randn(x.shape, generator=torch.Generator()
                              .manual_seed(50 + r)).to(dtype)
                  for r in range(world)]
            with parallel.using(mesh):
                blk = parallel.block(x, "data", dim).clone().requires_grad_()
                whole = parallel.gather_blocks(blk, dim, ("data",))
                whole.backward(gs[rank])
            out[f"{dtype} {dim}"] = {"x": x, "whole": whole.detach(),
                                     "grad": blk.grad, "gs": gs, "dim": dim}
    w = torch.randn((8, 6), generator=torch.Generator().manual_seed(2))
    a = torch.randn((3, 8), generator=torch.Generator().manual_seed(3 + rank))
    for hooks in (False, True):
        ag = a.clone().requires_grad_()
        with parallel.using(mesh):
            leaf = parallel.block(w, "data", 0).clone().requires_grad_()
            with parallel.regathering() if hooks else contextlib.nullcontext():
                whole = parallel.gather_blocks(leaf, 0, ("data",))
                alive = weakref.ref(whole)
                y = torch.tanh(ag @ whole)
            del whole
            kept = alive() is not None
            y.sum().backward()
        out[f"regather {hooks}"] = {"kept": kept, "grad": leaf.grad,
                                    "agrad": ag.grad}
    return out


def _fsdp_masks(world: int) -> dict:
    """``magnitude_masks`` at densities 0.5 and 0.25 and
    ``compress_with_masks`` (0.25, then int8 at the whole leaf's scale)
    of each family's params on each rank's FSDP blocks against the
    one-rank results' blocks, on each mesh: whether every leaf is bitwise
    the block, and how many leaves were held."""
    out = {}
    for mp in fsdp_meshes(world):
        mesh = make_host_mesh(mp, devices=[CPU])
        for name in FSDP_FAMILIES:
            params = get_model(config(name)).init(0, device=CPU)
            sh = fsdp_specs(params, mesh)
            placed = place(params, sh)
            ws = {k: w for k, w in params.items() if compressible(k, w)}
            ok, n = True, 0
            for density in (0.5, 0.25):
                whole = magnitude_masks(ws, density)
                local = magnitude_masks({k: placed[k] for k in ws}, density,
                                        shardings=sh)
                ok &= all(torch.equal(local[k], sh[k].block(whole[k]))
                          for k in ws)
                n += len(ws)
            cp, m = compress_with_masks(params, 0.25, 0, 8)
            with parallel.using(mesh):
                lcp, lm = compress_with_masks(placed, 0.25, 0, 8,
                                              shardings=sh)
            ok &= all(torch.equal(lcp[k], sh[k].block(cp[k]))
                      and torch.equal(lm[k], sh[k].block(m[k])
                                      if m[k].dim() else m[k]) for k in cp)
            out[f"{name} {mp}"] = {"bitwise": bool(ok), "masks": n}
    return out


def fsdp_one_rank(name: str) -> dict:
    """:data:`FSDP_STEPS` AdamW steps of the hetero train step in one
    process at :data:`FSDP_SHAPE`: the losses and the final params and
    moments."""
    cfg = config(name)
    model, opt = get_model(cfg), adamw()
    state = TrainState.create(model, opt, 0, device=CPU)
    step = make_hetero_train_step(model, opt, default_tier_plans(4))
    losses = []
    for i in range(FSDP_STEPS):
        state, m = step(state, make_train_batch(cfg, FSDP_SHAPE, n_tiers=4,
                                                seed=3, index=i))
        losses.append(m["loss"].item())
    return {"losses": losses, "params": state["params"],
            "m": state["opt"]["m"], "v": state["opt"]["v"]}


def _fsdp_steps(name: str, mp: int, fsdp: bool, ckpt: str | None) -> dict:
    """:func:`fsdp_one_rank`'s steps on the (world / mp, mp) mesh of ranks,
    FSDP-placed or on "model" alone: the losses, the collectives the last
    step counted (``parallel.counting``), the params and moments
    gathered whole, how many params leaves were split over "data", and
    with ``ckpt`` the final state saved there (every rank calls)."""
    cfg = config(name)
    model, opt = get_model(cfg), adamw()
    mesh = make_host_mesh(mp, devices=[CPU])
    state = TrainState.create(model, opt, 0, device=CPU)
    sh = fsdp_specs(state, mesh, fsdp)
    state = place(state, sh)
    step = make_hetero_train_step(model, opt, default_tier_plans(4),
                                  shardings=sh["params"])
    losses = []
    with parallel.using(mesh):
        for i in range(FSDP_STEPS):
            with parallel.counting() as census:
                state, m = step(state, make_train_batch(
                    cfg, FSDP_SHAPE, n_tiers=4, seed=3, index=i))
            losses.append(m["loss"].item())
    if ckpt is not None:
        Checkpointer(ckpt).save(state, FSDP_STEPS, shardings=sh)
    return {"losses": losses, "census": census.record(),
            "data_split": len(data_splits(sh["params"])),
            **{k: gather(v, sh["params"]) for k, v in (
                ("params", state["params"]), ("m", state["opt"]["m"]),
                ("v", state["opt"]["v"]))}}


def abstract_mesh(dp: int, mp: int) -> Mesh:
    """A (dp, mp) mesh of ``meta`` slots, as the production meshes."""
    devices = np.empty((dp, mp), dtype=object)
    devices.fill(torch.device("meta"))
    return Mesh(devices, ("data", "model"))


def dry_run_census(name: str, shape, dp: int, mp: int) -> dict:
    """The LM dry run's collective census of ``name``'s step at ``shape``
    (train, prefill or decode) on an abstract (dp, mp) mesh: rank 0's
    trace on fake tensors (``launch.specs.rank_traced``), no process
    group behind it."""
    counts, _, _ = specs_mod.rank_traced(config(name), shape,
                                         abstract_mesh(dp, mp))
    return counts["collectives"]


def _fsdp_arg_bytes(mp: int) -> dict:
    """A rank's placed FSDP train state of llama3.2-3b's smoke config on
    the (world / mp, mp) mesh, plus the batch rows the step takes on it
    (:data:`FSDP_SHAPE`, 4 tiers): their bytes."""
    cfg = config("llama3.2-3b")
    mesh = make_host_mesh(mp, devices=[CPU])
    state = TrainState.create(get_model(cfg), adamw(), 0, device=CPU)
    placed = place(state, fsdp_specs(state, mesh))
    batch = make_train_batch(cfg, FSDP_SHAPE, n_tiers=4, seed=3, index=0)
    with parallel.using(mesh):
        rows = steps_mod._data_rows(batch)
    return {"state": sum(t.numel() * t.element_size()
                         for t in _tensors(placed)),
            "batch": sum(t.numel() * t.element_size()
                         for t in rows.values())}


def reference_fsdp(arch: str, ref_dir: str, out_dir: str) -> dict:
    """The port's ``launch.specs.train_setup`` step of ``arch``'s smoke
    config at :data:`FSDP_SHAPE` on the (world / 2, 2) mesh of ranks,
    FSDP-placed by its own shardings, from the reference's init
    checkpoint in ``ref_dir`` (``tests/_reference_fsdp_step.py``), over
    the reference's three batches: the losses, the collectives the last
    step counted; the final state saved to ``out_dir`` (whole leaves, as
    the reference's)."""
    cfg = get_smoke_config(arch)
    mesh = make_host_mesh(2, devices=[CPU])
    step, _, (state_sh, _), _ = specs_mod.train_setup(cfg, FSDP_SHAPE, mesh)
    model = get_model(cfg)
    opt = optim.adamw(optim.warmup_cosine(3e-4, 100, 10_000))
    state = place(TrainState.create(model, opt, 0, device=CPU), state_sh)
    state, _ = Checkpointer(ref_dir).restore(state, 0, shardings=state_sh)
    losses = []
    with parallel.using(mesh):
        for i in range(FSDP_STEPS):
            with parallel.counting() as census:
                state, m = step(state, make_train_batch(cfg, FSDP_SHAPE,
                                                        n_tiers=4, seed=0,
                                                        index=i))
            losses.append(m["loss"].item())
    Checkpointer(out_dir).save(state, FSDP_STEPS, shardings=state_sh)
    return {"losses": losses, "mesh": dict(mesh.shape),
            "census": census.record(),
            "data_split": len(data_splits(state_sh["params"]))}


def run_fsdp(world: int, extra: dict) -> dict:
    """Every rank-side check of ``tests/test_torch_fsdp*.py`` for ``world``
    ranks that ``extra`` asks for."""
    if "reference" in extra:
        return {arch: reference_fsdp(arch, *dirs)
                for arch, dirs in extra["reference"].items()}
    mp = fsdp_step_mesh(world)
    out = {"round_trips": _fsdp_round_trips(world),
           "gathers": _fsdp_gathers(world),
           "masks": _fsdp_masks(world),
           "arg_bytes": {mp: _fsdp_arg_bytes(mp)},
           "steps": {}}
    for name in FSDP_FAMILIES:
        for fsdp in (True, False):
            ckpt = (os.path.join(extra["ckpt"], f"{name} {mp}") if fsdp
                    else None)
            out["steps"][f"{name} {mp} {fsdp}"] = _fsdp_steps(
                name, mp, fsdp, ckpt)
    return out


# -------------------------------------------------------------- launcher

def _launcher(world: int, mp: int) -> dict:
    """``launch.train.train`` with ``WORLD_SIZE`` set (as under torchrun):
    its mesh and losses."""
    os.environ.update(WORLD_SIZE=str(world), RANK=str(dist.get_rank()),
                      LOCAL_RANK=str(dist.get_rank()))
    meshes = []
    make = train_mod.make_host_mesh

    def spy(*a, **k):
        meshes.append(make(*a, **k))
        return meshes[-1]

    train_mod.make_host_mesh = spy
    try:
        res = train_mod.train(get_smoke_config("llama3.2-3b"), steps=1,
                              batch=8, seq=8, device="cpu", log_every=1,
                              model_parallel=mp)
    finally:
        train_mod.make_host_mesh = make
    (mesh,) = meshes
    return {"shape": dict(mesh.shape), "ranks": mesh.ranks.tolist(),
            "distinct": [str(x) for x in mesh.distinct_devices()],
            "coords": mesh.coords(), "losses": res["losses"]}


def ckpt_state(name: str = "qwen-h8") -> dict:
    """The train state a checkpoint crossing saves (seed 1)."""
    model, opt = get_model(config(name)), optim.adamw(1e-3)
    return TrainState.create(model, opt, 1, device=CPU)


def _restore_and_save(src: str, dst: str, name: str) -> dict:
    """A one-rank checkpoint of :func:`ckpt_state` restored on the
    (1, world) mesh, and saved back from every rank: whether each
    restored leaf is bitwise this rank's placed block, and the step."""
    state = ckpt_state(name)
    mesh = make_host_mesh(dist.get_world_size(), devices=[CPU])
    sh = named(mesh, param_spec_tree(state, mesh.shape["model"]))
    placed = place(state, sh)
    restored, step = Checkpointer(src).restore(placed, shardings=sh)
    Checkpointer(dst).save(restored, step, shardings=sh)
    same = all(torch.equal(a, b) for a, b in zip(
        _tensors(restored), _tensors(placed)))
    return {"same": same, "step": step}


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    return [tree]


# ------------------------------------------------ test-side comparisons

def check_steps(results, name: str, mp: int, one: dict) -> None:
    """Two AdamW steps of the hetero train step (4 tiers, batch 8 x 16)
    under the train launcher's schedule on the mesh against one rank
    (``one``, :func:`one_rank_steps`): losses rtol 1e-4, params atol
    1e-5, Adam's moments (linear in the gradients) rtol 1e-4 / atol
    1e-7; every rank the same losses and gathered params. AdamW's update
    is sign-like: a gradient that is rounding noise in both orders of
    summation (|g| far below eps) moves its weight by up to +-lr in
    either, so the params are held under the launcher's warmup, where lr
    stays small, and the gradients through the moments."""
    got = results[0]["steps"][f"{name} {mp}"]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-4)
    for k, v in one["params"].items():
        torch.testing.assert_close(got["params"][k], v, rtol=0, atol=1e-5,
                                   msg=k)
        for mom in ("m", "v"):
            torch.testing.assert_close(got[mom][k], one[mom][k], rtol=1e-4,
                                       atol=1e-7, msg=f"{mom} {k}")
    for res in results[1:]:
        r = res["steps"][f"{name} {mp}"]
        assert r["losses"] == got["losses"]
        assert all(torch.equal(r["params"][k], got["params"][k])
                   for k in got["params"])


def npz(path) -> dict:
    """A checkpoint file's leaves: name -> (array, dtype name)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        return {m["name"]: (z[k], m["dtype"]) for k, m in meta.items()}


def _losses(log: str) -> dict:
    return {int(m["step"]): m["loss"] for m in
            (json.loads(line) for line in log.splitlines()
             if re.match(r'^\{"step"', line))}


def launcher_vs_reference(tmp_path: Path, arch: str, mp: int) -> None:
    """The reference's launcher on 4 host devices (a (4 / mp, mp) mesh at
    --model-parallel mp), 3 steps with a checkpoint each; the port's on 4
    gloo ranks under torchrun resumes from a copy of its step-1
    checkpoint to step 3: printed losses within 1e-4, every leaf of the
    step-3 checkpoint within 1e-5 (names and dtypes equal); that file,
    written by 4 ranks, restores bitwise in one process."""
    args = ["--arch", arch, "--smoke", "--steps", "3", "--batch",
            "8", "--seq", "32", "--model-parallel", str(mp),
            "--ckpt-every", "1", "--log-every", "1"]
    mesh = f"mesh={{'data': {4 // mp}, 'model': {mp}}}"
    ref, port = tmp_path / "ref", tmp_path / "port"
    ref_env = env()
    ref_env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    ref_env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-m", "repro.launch.train", *args,
                        "--ckpt-dir", str(ref)], env=ref_env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert mesh in r.stdout
    ref_losses = _losses(r.stdout)
    port.mkdir()
    shutil.copy(ref / "ckpt_00000001.npz", port)
    p = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc-per-node", "4",
                        "-m", "repro_torch.launch.train", *args,
                        "--ckpt-dir", str(port), "--device", "cpu"],
                       env=env(), capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "restored step 1" in p.stdout
    assert mesh in p.stdout
    got = _losses(p.stdout)
    assert sorted(got) == [2, 3]
    for step, loss in got.items():
        np.testing.assert_allclose(loss, ref_losses[step], rtol=1e-4)
    a, b = npz(ref / "ckpt_00000003.npz"), npz(port / "ckpt_00000003.npz")
    assert set(a) == set(b)
    for k, (v, dt) in a.items():
        assert b[k][1] == dt, k
        np.testing.assert_allclose(b[k][0], v, rtol=0, atol=1e-5, err_msg=k)
    # the 4-rank file in one process
    model = get_model(get_smoke_config(arch))
    template = TrainState.create(model, optim.adamw(1e-3), 0, device=CPU)
    state, step = Checkpointer(str(port)).restore(template)
    assert step == 3
    flat = dict(named_leaves(state))
    assert set(flat) == set(b)
    for k, t in flat.items():
        assert np.array_equal(t.numpy(), b[k][0]), k


# ------------------------------------------------------------------ entry

def env() -> dict:
    """The environment of a rank (or reference) process: the port's
    ``src`` and this directory on the path, one thread."""
    out = dict(os.environ)
    out["PYTHONPATH"] = os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE)]
        + ([out["PYTHONPATH"]] if out.get("PYTHONPATH") else []))
    out["OMP_NUM_THREADS"] = "1"
    return out


def spawn(world: int, out: Path, extra: dict,
          timeout: int = RANK_TIMEOUT) -> list[dict]:
    """Runs this file's rank checks in ``world`` processes (the test
    side); each rank's results. A rank that fails or outlasts
    ``timeout`` seconds fails the caller."""
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "_parallel_workers.py"), str(world),
         str(r), str(out / "store"), str(out), json.dumps(extra)],
        env=env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {world}: {logs[r][-3000:]}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def run(rank: int, world: int, store: str, out: str, extra: dict) -> None:
    """One rank: every check for ``world`` ranks, its results saved to
    ``out/rank{rank}.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    if "recurrent" in extra:    # xLSTM, Zamba and Whisper alone
        torch.save(run_recurrent(world, extra["recurrent"]),
                   os.path.join(out, f"rank{rank}.pt"))
        dist.destroy_process_group()
        return
    if "fsdp" in extra:         # the FSDP layout alone
        torch.save(run_fsdp(world, extra["fsdp"]),
                   os.path.join(out, f"rank{rank}.pt"))
        dist.destroy_process_group()
        return
    if "serve_ref" in extra:    # against the reference's sharded serve
        res = {arch: reference_serve(arch, d)
               for arch, d in extra["serve_ref"].items()}
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
        dist.destroy_process_group()
        return
    if "bf16" in extra:         # the reference's bf16 step on (1, 2) alone
        res = {arch: bf16_step(arch, ckpt)
               for arch, ckpt in extra["bf16"].items()}
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
        dist.destroy_process_group()
        return
    res = {"meshes": {}}
    for mp in (1, 2, world):
        mesh = make_host_mesh(mp, devices=[CPU])
        res["meshes"][mp] = {"shape": dict(mesh.shape),
                             "ranks": mesh.ranks.tolist(),
                             "coords": mesh.coords()}
    res["layers"] = _layer_cases(world)
    res["masks"] = _masks(world)
    res["round_trips"] = _round_trips(
        [(n, 2) for n in (*DENSE, "granite-3-2b-v515", "deepseek-7b-v515")]
        + OTHER_LAYOUTS[world])
    res["steps"] = {f"{name} {mp}": _mesh_steps(name, mp)
                    for name, mp in extra["steps"]}
    res["launcher"] = _launcher(world, 2)
    res["families"] = _family_losses(world)
    res["serve"] = _serve_runs(world)
    for name, (src, dst) in extra.get("ckpt", {}).items():
        res["ckpt" if name == "qwen-h8" else f"ckpt {name}"] = \
            _restore_and_save(src, dst, name)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    run(int(sys.argv[2]), int(sys.argv[1]), sys.argv[3], sys.argv[4],
        json.loads(sys.argv[5]))
