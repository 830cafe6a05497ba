"""Dry-run wiring: fake-tensor stand-ins for every model input plus
NamedShardings, per (architecture x input-shape x mesh), as the
reference's ``launch/specs.py``.

No tensor storage is ever allocated here: states, params, caches and
batches are fake tensors of :func:`fake_mode` (the counterpart of the
reference's ``jax.eval_shape`` and ``ShapeDtypeStruct``), so full-scale
(34B-param) configs set up on a laptop-class host.

A step is traced twice for a record: once whole (:func:`traced`, the
global flops and traffic, shared across meshes) and once as one rank of
the mesh runs it (:func:`rank_traced`): the sharded program of
``models/parallel.py`` on a census mesh of the mesh's shape, from that
rank's blocks of the train state (train), of the deployed params
(prefill) or of the deployed params and the cache (decode), its
collectives counted and none sent.
"""
from __future__ import annotations

import time

import torch

from repro_torch import optim
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.compression import compressible, default_tier_plans
from repro_torch.core.steps import (TrainState, make_hetero_train_step,
                                    make_prefill_step, make_serve_step)
from repro_torch.launch.analysis import trace_step
from repro_torch.launch.mesh import batch_axes, census_mesh, num_batch_shards
from repro_torch.models import get_model, parallel
from repro_torch.models.sharding import (P, NamedSharding, blocks,
                                         cache_spec_tree,
                                         make_activation_rules, named,
                                         param_spec_tree, set_rules)

N_TIERS = 4
_FAKE = None
# (cfg, shape, num_groups as the step uses it, setup keywords) -> (the
# trace's counts, fake outputs, seconds), shared by the meshes where
# these agree
_TRACES: dict = {}
# (cfg, shape, mesh shape, rank, setup keywords) -> a rank's trace, as
# _TRACES holds the global ones
_RANK_TRACES: dict = {}


def fake_mode():
    """The module's ``FakeTensorMode``: every stand-in it makes belongs to
    it, and a step runs on them under it."""
    global _FAKE
    if _FAKE is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        _FAKE = FakeTensorMode(allow_non_fake_inputs=True)
    return _FAKE


def traced(cfg: ModelConfig, shape: ShapeConfig, mesh, step, args,
           setup_kw: dict | None = None) -> tuple[dict, object, float]:
    """(counts, fake outputs, seconds) of ``step(*args)`` traced on fake
    tensors (``launch.analysis.trace_step``), once per key of
    ``_TRACES``: ``num_groups`` reaches only a MoE layer's prefill and
    decode (the train loss does not pass it on, as in the reference)."""
    groups = (num_batch_shards(mesh)
              if cfg.is_moe and shape.mode != "train" else None)
    key = (cfg, shape, groups, tuple(sorted((setup_kw or {}).items())))
    if key not in _TRACES:
        t0 = time.time()
        counts, out = trace_step(step, *args)
        _TRACES[key] = counts, out, round(time.time() - t0, 1)
    return _TRACES[key]


def rank_traced(cfg: ModelConfig, shape: ShapeConfig, mesh,
                setup_kw: dict | None = None,
                rank: int = 0) -> tuple[dict, object, float]:
    """(counts, fake outputs, seconds) of ``rank``'s step on ``mesh``'s
    shape (:func:`setup_for` over ``launch.mesh.census_mesh(mesh,
    rank)``), traced on fake tensors inside ``parallel.using`` that mesh.
    A train step takes the rank's blocks of the FSDP train state
    (``sharding.blocks``) and the batch, of which it reads the rank's
    rows, as every rank of a real mesh does; a prefill step the rank's
    blocks of the deployed params and the batch; a decode step the
    rank's blocks of the deployed params and of the cache
    (``cache_spec_tree``) and the tokens. Its counts' ``collectives`` and
    ``temp_bytes`` are the rank's; its flops and traffic are the rank's
    share, not the reference's global ones. Traced once per key of
    ``_RANK_TRACES``; on a mesh of one device the rank's trace is the
    global one."""
    key = (cfg, shape, tuple(mesh.shape.items()), rank,
           tuple(sorted((setup_kw or {}).items())))
    if key not in _RANK_TRACES:
        census = census_mesh(mesh, rank)
        step, args, in_sh, _ = setup_for(cfg, shape, census,
                                         **(setup_kw or {}))
        if not census.is_distributed:
            return traced(cfg, shape, mesh, step, args, setup_kw)
        # the state, params and cache as the rank's blocks; the batch and
        # the tokens whole (the step reads the rank's rows)
        cut = (0,) if shape.mode != "decode" else (0, 1)
        with fake_mode():
            args = tuple(blocks(a, sh) if i in cut else a
                         for i, (a, sh) in enumerate(zip(args, in_sh)))
        t0 = time.time()
        with parallel.using(census):
            counts, out = trace_step(step, *args)
        _RANK_TRACES[key] = counts, out, round(time.time() - t0, 1)
    return _RANK_TRACES[key]


def window_for(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Sub-quadratic fallback: the long_500k decode shape uses sliding-window
    attention for every arch that has a growing KV cache (SSMs keep their
    native constant-size state). See DESIGN.md long_500k policy."""
    if shape.name == "long_500k" and cfg.family != "ssm":
        return cfg.long_context_window
    return cfg.sliding_window


def cache_len_for(cfg: ModelConfig, shape: ShapeConfig) -> int:
    w = window_for(cfg, shape)
    return min(shape.seq_len, w) if w else shape.seq_len


def _batch_spec(mesh, b: int):
    ax = batch_axes(mesh)
    return ax if (ax and b % num_batch_shards(mesh) == 0) else None


def _empty(shape, dtype) -> torch.Tensor:
    with fake_mode():
        return torch.empty(shape, dtype=dtype)


def _batch_structs(cfg: ModelConfig, shape: ShapeConfig, lead: tuple[int, ...],
                   *, labels: bool) -> dict:
    """Training/prefill batch stand-ins with `lead` leading dims; tokens
    int32, as the port's batches are."""
    t = shape.seq_len
    dt = getattr(torch, cfg.dtype)
    extra = 1 if labels else 0
    batch = {}
    if cfg.family == "audio":
        batch["frames"] = _empty((*lead, cfg.encoder_seq, cfg.d_model), dt)
        batch["tokens"] = _empty((*lead, t + extra), torch.int32)
    elif cfg.family == "vlm":
        batch["patches"] = _empty((*lead, cfg.num_patches, cfg.d_model), dt)
        batch["tokens"] = _empty((*lead, t - cfg.num_patches + extra),
                                 torch.int32)
    else:
        batch["tokens"] = _empty((*lead, t + extra), torch.int32)
    return batch


def _batch_shardings(batch, mesh, bspec, tiered: bool):
    def spec(leaf):
        nd = len(leaf.shape)
        lead = (None, bspec) if tiered else (bspec,)
        return NamedSharding(mesh, P(*lead, *(None,) * (nd - len(lead))))
    return {k: spec(v) for k, v in batch.items()}


def _msize(mesh) -> int:
    return mesh.shape["model"]


def _install_rules(mesh, b: int, cfg, shape=None):
    bspec = _batch_spec(mesh, b)
    if not bspec:
        set_rules({})
        return
    ms = _msize(mesh)
    # sequence parallelism was tried and REFUTED for this codebase
    # (EXPERIMENTS.md §Perf, qwen2.5 iteration 2): chunked attention's
    # dynamic q-slices over a T-sharded residual made GSPMD re-gather
    # activations per chunk (collective bytes 16.3 s -> 88.7 s). Kept off.
    seq_shard = False
    set_rules(make_activation_rules(
        mesh, bspec,
        vocab_ok=cfg.vocab_size % ms == 0,
        experts_ok=cfg.num_experts % ms == 0 if cfg.is_moe else True,
        seq_shard=seq_shard))


def _deployed_params(model, cfg):
    """Stand-ins of a DEPLOYED (compressed) model: compressible weights
    stored in the compute dtype (the paper's devices hold the compressed
    model, not the f32 master copy) — halves serving HBM and weight
    traffic vs f32 stand-ins."""
    dt = getattr(torch, cfg.dtype)
    with fake_mode():
        params = model.init(0, device="cpu")
        return {k: v.to(dt) if compressible(k, v) else v
                for k, v in params.items()}


def train_setup(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                n_tiers: int = N_TIERS):
    """Returns (step_fn, args, in_shardings, out_shardings) for the tiered
    federated train step."""
    assert shape.mode == "train"
    model = get_model(cfg)
    opt = optim.adamw(optim.warmup_cosine(3e-4, 100, 10_000))
    ng = num_batch_shards(mesh)
    _install_rules(mesh, shape.global_batch // n_tiers, cfg, shape)

    with fake_mode():
        state = TrainState.create(model, opt, 0, device="cpu")
    per_tier = shape.global_batch // n_tiers
    batch = _batch_structs(cfg, shape, (n_tiers, per_tier), labels=True)

    # FSDP: the train state (params + Adam moments + accumulators) shards
    # over the data axes too — without it 30B+ states exceed v5e HBM
    # (llava-next: 26 GB/chip of arguments model-sharded only; 1.6 GB with
    # FSDP). GSPMD re-gathers weights per layer inside the scan.
    fsdp = (batch_axes(mesh), num_batch_shards(mesh))
    state_sh = named(mesh, param_spec_tree(state, _msize(mesh), fsdp))
    # shardings=: over a mesh of ranks the step runs this layout (each
    # rank's blocks, the FSDP leaves gathered where a layer uses them); on
    # the abstract meshes it traces as without
    step = make_hetero_train_step(model, opt, default_tier_plans(n_tiers),
                                  num_groups=ng,
                                  acc_shardings=state_sh["params"],
                                  shardings=state_sh["params"])
    bspec = _batch_spec(mesh, per_tier)
    batch_sh = _batch_shardings(batch, mesh, bspec, tiered=True)
    out_sh = (state_sh, {"loss": NamedSharding(mesh, P()),
                         "tier_loss": NamedSharding(mesh, P(None))})
    return step, (state, batch), (state_sh, batch_sh), out_sh


def prefill_setup(cfg: ModelConfig, shape: ShapeConfig, mesh):
    assert shape.mode == "prefill"
    model = get_model(cfg)
    ng = num_batch_shards(mesh)
    step = make_prefill_step(model, window=window_for(cfg, shape),
                             num_groups=ng)
    _install_rules(mesh, shape.global_batch, cfg, shape)

    batch = _batch_structs(cfg, shape, (shape.global_batch,), labels=False)
    params = _deployed_params(model, cfg)
    params_sh = named(mesh, param_spec_tree(params, _msize(mesh)))
    bspec = _batch_spec(mesh, shape.global_batch)
    batch_sh = _batch_shardings(batch, mesh, bspec, tiered=False)

    # the prefill's cache, from the trace the dry run counts (a time loop
    # by its multiplier)
    _, cache = traced(cfg, shape, mesh, step, (params, batch))[1]
    cache_sh = named(mesh, cache_spec_tree(cache, bspec, _msize(mesh)))
    out_sh = (NamedSharding(mesh, P()), cache_sh)
    return step, (params, batch), (params_sh, batch_sh), out_sh


def decode_setup(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """The decode step at the shape's last position (``pos`` is a host
    int in the port, so it has no sharding of its own)."""
    assert shape.mode == "decode"
    model = get_model(cfg)
    ng = num_batch_shards(mesh)
    w = window_for(cfg, shape)
    step = make_serve_step(model, window=w, num_groups=ng)
    _install_rules(mesh, shape.global_batch, cfg, shape)

    b = shape.global_batch
    params = _deployed_params(model, cfg)
    with fake_mode():
        cache = model.init_cache(b, cache_len_for(cfg, shape), device="cpu")
    tokens = _empty((b, 1), torch.int32)
    pos = shape.seq_len - 1

    params_sh = named(mesh, param_spec_tree(params, _msize(mesh)))
    bspec = _batch_spec(mesh, b)
    cache_sh = named(mesh, cache_spec_tree(cache, bspec, _msize(mesh)))
    tok_sh = NamedSharding(mesh, P(bspec, None))
    out_sh = (NamedSharding(mesh, P()), cache_sh)
    return step, (params, cache, tokens, pos), \
        (params_sh, cache_sh, tok_sh, None), out_sh


def setup_for(cfg: ModelConfig, shape: ShapeConfig, mesh, **kw):
    if shape.mode == "train":
        return train_setup(cfg, shape, mesh, **kw)
    if shape.mode == "prefill":
        return prefill_setup(cfg, shape, mesh)
    return decode_setup(cfg, shape, mesh)
