"""The rank side of ``tests/test_torch_parallel.py``: each of ``world``
processes runs this file on the CPU over gloo,

    python tests/_parallel_workers.py WORLD RANK STORE OUT EXTRA_JSON

and saves its results to ``OUT/rank{RANK}.pt`` for the test to read.
JAX-free, so the ranks import torch and the port alone. The ranks meet
through a file store, not a port, so test workers running side by side
never collide.
"""
from __future__ import annotations

import json
import os
import sys

import torch
import torch.distributed as dist

from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.core.compression import (compress_with_masks,
                                          default_tier_plans,
                                          magnitude_masks)
from repro_torch.core.steps import TrainState, make_hetero_train_step
from repro_torch.data.synthetic import make_train_batch
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model, parallel
from repro_torch.models import layers as L
from repro_torch.models.sharding import (P, NamedSharding, gather, named,
                                         param_spec_tree, place, shard_bytes)

CPU = torch.device("cpu")
DENSE = ("llama3.2-3b", "granite-3-2b", "qwen2.5-32b", "deepseek-7b")
STEPS = 2
SHAPE = ShapeConfig("t", 16, 8, "train")


def adamw():
    """The train launcher's default optimizer: AdamW(warmup_cosine(3e-4,
    20, 100))."""
    return optim.adamw(optim.warmup_cosine(3e-4, 20, 100))


def config(name: str):
    """The dense smoke configs, plus: ``*-v515`` at an odd vocabulary
    (the d_model fallback of the embedding and lm_head); ``qwen-h8``,
    qwen's smoke config at 8 / 4 heads, which split 4 ways."""
    if name.endswith("-v515"):
        return get_smoke_config(name[:-5]).replace(vocab_size=515)
    if name == "qwen-h8":
        return get_smoke_config("qwen2.5-32b").replace(
            num_heads=8, num_kv_heads=4, head_dim=16)
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
            state, m = step(state, make_train_batch(cfg, SHAPE, n_tiers=4,
                                                    seed=3, index=i))
            losses.append(m["loss"].item())
    return {"losses": losses,
            **{k: gather(v, sh["params"]) for k, v in (
                ("params", state["params"]), ("m", state["opt"]["m"]),
                ("v", state["opt"]["v"]))}}


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
    return {name: (_run(fn, p, xx, dims, mesh), _run(fn, p, xx, dims))
            for name, (fn, p, xx, dims) in cases.items()}


# --------------------------------------------------------- place / masks

def _round_trips(mp: int) -> dict:
    """For each dense smoke config (and the odd vocabulary) at ``mp``
    model shards: the specs, and whether every placed leaf is the block
    of the whole one, gathers back bitwise, and the bytes equal
    ``shard_bytes``."""
    mesh = make_host_mesh(mp, devices=[CPU])
    out = {}
    for name in (*DENSE, "granite-3-2b-v515", "deepseek-7b-v515"):
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
        out[name] = {"specs": {k: tuple(v) for k, v in specs["params"]
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
    masks' blocks, per density; and ``compress_with_masks`` of qwen-h8's
    params (pruned, then fp8 e5m2 or int8, whose per-tensor scale is the
    whole leaf's) against one rank's blocks."""
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
    cfg = config("qwen-h8")
    params = get_model(cfg).init(0, device=CPU)
    psh = named(mesh, param_spec_tree(params, world))
    for label, e, m_bits in (("fp8", 5, 2), ("int8", 0, 8)):
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


def ckpt_state() -> dict:
    """The train state the checkpoint crossing saves (qwen-h8, seed 1)."""
    cfg = config("qwen-h8")
    model, opt = get_model(cfg), optim.adamw(1e-3)
    return TrainState.create(model, opt, 1, device=CPU)


def _restore_and_save(src: str, dst: str) -> dict:
    """A one-rank checkpoint of :func:`ckpt_state` restored on the
    (1, world) mesh, and saved back from every rank: whether each
    restored leaf is bitwise this rank's placed block, and the step."""
    state = ckpt_state()
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


# ------------------------------------------------------------------ entry

def run(rank: int, world: int, store: str, out: str, extra: dict) -> None:
    """One rank: every check for ``world`` ranks, its results saved to
    ``out/rank{rank}.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    res = {"meshes": {}}
    for mp in (1, 2, world):
        mesh = make_host_mesh(mp, devices=[CPU])
        res["meshes"][mp] = {"shape": dict(mesh.shape),
                             "ranks": mesh.ranks.tolist(),
                             "coords": mesh.coords()}
    res["layers"] = _layer_cases(world)
    res["masks"] = _masks(world)
    res["round_trips"] = _round_trips(2)
    res["steps"] = {f"{name} {mp}": _mesh_steps(name, mp)
                    for name, mp in extra["steps"]}
    res["launcher"] = _launcher(world, 2)
    if "ckpt" in extra:
        res["ckpt"] = _restore_and_save(*extra["ckpt"])
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    run(int(sys.argv[2]), int(sys.argv[1]), sys.argv[3], sys.argv[4],
        json.loads(sys.argv[5]))
