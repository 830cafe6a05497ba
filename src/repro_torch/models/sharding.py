"""Sharding: logical-rule registry for activation hints + a path-based
PartitionSpec builder for parameter/cache trees, as the reference's
``models/sharding.py``.

The launcher builds parameter shardings from ``param_spec_tree``
(Megatron-style: heads / d_ff / vocab / experts on the "model" axis,
batch on ("pod", "data")). A leaf is matched by its path as the
reference names it: the port's flat keys split at ``.`` and joined with
``/`` (``layers.attn.wq.w`` of ``params`` is ``params/layers/attn/wq/w``),
the checkpoint's names (:func:`repro_torch.checkpoint.checkpointer.map_named`).

Placement: :func:`place` is the counterpart of ``jax.device_put(tree,
shardings)``. A mesh whose slots are one device (the one card, or the
CPU repeated in tests) moves each leaf there; a mesh of several distinct
devices raises, since splitting a leaf across cards needs
``torch.distributed`` (ROADMAP queue 1, item 20). The reference's
activation hints are layout constraints with no effect on values and
the port places no activation across devices, so :func:`hint` returns
its input and the models need not call it.
"""
from __future__ import annotations

import math
import re
from typing import Any

import torch

from repro_torch.checkpoint.checkpointer import map_named


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or
    a tuple of axis names (one name alone stands as itself, as in JAX);
    compares as the tuple, prints as ``P(...)``."""

    def __new__(cls, *spec):
        return super().__new__(cls, (_entry(e) for e in spec))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(s) for s in self) + ")"


def _entry(e):
    if isinstance(e, (tuple, list)):
        return e[0] if len(e) == 1 else tuple(e)
    return e


P = PartitionSpec


class NamedSharding:
    """A :class:`PartitionSpec` over a mesh's named axes."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def _ways(self, entry) -> int:
        if entry is None:
            return 1
        axes = (entry,) if isinstance(entry, str) else entry
        return math.prod(self.mesh.shape[a] for a in axes)

    def shard_shape(self, shape) -> tuple[int, ...]:
        """One device's block of a tensor of ``shape`` (every sharded dim
        divides evenly, as pjit requires)."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec!r} has more dims than "
                             f"shape {shape}")
        out = list(shape)
        for dim, entry in enumerate(self.spec):
            ways = self._ways(entry)
            if shape[dim] % ways:
                raise ValueError(f"dim {dim} of {shape} does not divide "
                                 f"over {ways} shards ({self.spec!r})")
            out[dim] = shape[dim] // ways
        return tuple(out)


# ------------------------------------------------------- activation hints

_RULES: dict[str, Any] = {}


def set_rules(rules: dict[str, Any]) -> None:
    """rules: logical name -> NamedSharding (or None to clear)."""
    global _RULES
    _RULES = dict(rules)


def clear_rules() -> None:
    set_rules({})


def hint(x, name: str):
    """``x``: the reference constrains its layout by the rule named
    ``name``, which has no effect on values; the port places no
    activation across devices."""
    return x


def make_activation_rules(mesh, batch_axes, *, vocab_ok: bool = True,
                          experts_ok: bool = True,
                          seq_shard: bool = False) -> dict[str, Any]:
    def ns(*spec):
        return NamedSharding(mesh, P(*spec))
    return {
        # §Perf hillclimb #3: sequence parallelism — with T on "model" the
        # post-attention/post-MLP partial sums reduce-scatter to small
        # T-sharded f32 tiles (norms/residuals run T-sharded) and re-gather
        # as bf16 before the next projection, instead of all-reducing
        # full f32 (B,T,D) activations (Megatron-SP, GSPMD-inferred).
        "act_btd": ns(batch_axes, "model" if seq_shard else None, None),
        "act_btf": ns(batch_axes, None, "model"),   # (B, T, F) ff-sharded
        "logits": ns(batch_axes, None, "model" if vocab_ok else None),
        # §Perf hillclimb #1 (EXPERIMENTS.md): with einsum dispatch, both
        # the (g,e,c,d) capacity buffer and the (g,n,e,c) dispatch/combine
        # masks shard cleanly: groups on data, experts on model — every
        # expert contraction is then shard-local and only the combine's
        # e-partial sums all-reduce (g,n,d)-sized activations.
        "moe_buf": ns(batch_axes, "model" if experts_ok else None, None, None),
        "moe_mask": ns(batch_axes, None, "model" if experts_ok else None, None),
        # decode scores (B, H, 1, S): keep S on "model" so flash-decoding
        # partials stay local — without this constraint GSPMD prefers
        # all-gathering the S-sharded KV cache (~1 GB/layer/token).
        "dec_scores": ns(batch_axes, None, None, "model"),
    }


# ----------------------------------------------- parameter PartitionSpecs
#
# Matched against "/".join(path keys) for each leaf; first match wins.
# Each rule lists CANDIDATE dims (negative = from the end of the shape) to
# place on the "model" axis, in preference order; the first candidate whose
# size divides the axis evenly is used, else the leaf is replicated. This
# gives Megatron-style sharding where divisible (heads / d_ff / vocab /
# experts) with automatic per-tensor fallback (e.g. 24 heads on a 16-wide
# axis -> shard head_dim=128 instead). pjit rejects uneven shardings, so
# divisibility is checked against the actual mesh.

_PARAM_RULES: list[tuple[re.Pattern, tuple[int, ...]]] = [
    (re.compile(p), c) for p, c in [
        # embeddings / unembedding (odd vocabs like 49155 fall back to D)
        (r"(^|/)embed$",                      (-2, -1)),      # (V, D)
        (r"(^|/)pos_embed$",                  ()),
        (r"(^|/)lm_head/w$",                  (-1, -2)),      # (D, V)
        # attention: heads, else head_dim, else input dim
        (r"attn[^/]*/w[qkv]/w$",              (-2, -1, -3)),  # (D, H, hd)
        (r"attn[^/]*/w[qkv]/b$",              (-2, -1)),      # (H, hd)
        (r"attn[^/]*/wo/w$",                  (-2, -1)),      # (H*hd, D)
        (r"attn[^/]*/wo/b$",                  ()),
        # dense MLPs
        (r"mlp/w[ig]/w$",                     (-1,)),         # (D, F)
        (r"mlp/w[ig]/b$",                     (-1,)),
        (r"mlp/wo/w$",                        (-2,)),         # (F, D)
        (r"mlp/wo/b$",                        ()),
        # MoE (experts on model = expert parallelism)
        (r"moe/router/w$",                    ()),            # (D, E)
        (r"moe/we_[igo]$",                    (-3,)),         # (E, D, F)
        # mamba2 / ssd
        (r"mamba/in_proj/w$",                 (-1,)),         # (D, X)
        (r"mamba/conv_w$",                    (-2,)),         # (C, W)
        (r"mamba/(conv_b|a_log|dt_bias|d_skip|gate_norm)$", (-1,)),
        (r"mamba/out_proj/w$",                (-2,)),         # (d_in, D)
        # xlstm
        (r"(mlstm|slstm)/(up|qkv|gates|gates_x)/w$", (-1,)),
        (r"(mlstm|slstm)/(up|qkv|gates|gates_x)/b$", (-1,)),
        (r"(mlstm|slstm)/down/w$",            (-2,)),
        (r"(mlstm|slstm)/r_gates$",           (-1, -2)),      # (4, H, hd, hd)
        (r"(mlstm|slstm)/(skip|mnorm|gnorm)$", (-1,)),
        # vlm projector
        (r"projector/w$",                     (-1,)),
    ]]


def _spec_for(path: str, shape: tuple[int, ...], model_size: int,
              fsdp=None) -> P:
    """fsdp: optional (axes_tuple, size) — after the "model" dim is chosen,
    the largest REMAINING divisible dim is sharded over the data axes
    (ZeRO-3 / FSDP). Without it a 34B train state is only 16-way sharded
    (~26 GB/chip of args on llava-next — over v5e HBM); with it the state
    spreads over all 256/512 chips and GSPMD all-gathers weights layer-by-
    layer inside the scan. The dry-run's memory_analysis is the proof."""
    nd = len(shape)
    spec = [None] * nd
    matched = False
    for pat, candidates in _PARAM_RULES:
        if pat.search(path):
            matched = True
            for c in candidates:
                dim = nd + c
                if 0 <= dim < nd and shape[dim] % model_size == 0 \
                        and shape[dim] >= model_size:
                    spec[dim] = "model"
                    break
            break
    if matched and fsdp is not None:
        axes, size = fsdp
        dims = sorted(range(nd), key=lambda d: -shape[d])
        for d in dims:
            if spec[d] is None and shape[d] % size == 0 and shape[d] >= size:
                spec[d] = axes
                break
    return P(*spec)


def param_spec_tree(params, model_size: int = 16, fsdp=None) -> Any:
    """PartitionSpec tree mirroring a parameter tree (a name -> tensor
    dict, or the train state ``{"params", "opt", "step"}``; fake tensors
    too). fsdp=(batch_axes, n_shards) adds ZeRO-3 data-axis sharding of
    parameters/optimizer state."""
    return map_named(lambda path, leaf: _spec_for(path, tuple(leaf.shape),
                                                  model_size, fsdp), params)


# name-suffix -> (trailing-ndim, batch dim from end, model candidates from end)
_CACHE_RULES: list[tuple[re.Pattern, tuple | None]] = [
    (re.compile(p), s) for p, s in [
        (r"(^|/)slot_pos$",      None),
        # §Perf hillclimb #2 (EXPERIMENTS.md): decode caches shard the
        # SEQUENCE dim on "model" (flash-decoding style): per-shard partial
        # scores/softmax + one tiny (B,1,H,hd) all-reduce per layer,
        # instead of gathering head_dim-sharded caches (8.6 GB/layer/step
        # on llama3.2 decode_32k). Falls back to Hkv, then hd, when S is
        # not divisible (e.g. whisper's 1500-frame cross-KV).
        (r"(^|/)(enc_)?[kv]$",   (4, -4, (-3, -2, -1))),  # (B, S, Hkv, hd)
        (r"(^|/)enc_x$",         (3, -3, ())),         # (B, S, D)
        (r"(^|/)conv$",          (3, -3, (-1,))),      # (B, W, C)
        (r"(^|/)ssm$",           (4, -4, (-3,))),      # (B, H, P, N)
        (r"(^|/)mC$",            (4, -4, (-3, -1))),   # (B, H, dv, dk)
        (r"(^|/)(mn|sn|sc|sh)$", (3, -3, (-2, -1))),   # (B, H, d)
    ]]


def cache_spec_tree(cache, batch_axes, model_size: int = 16) -> Any:
    """PartitionSpec tree for decode caches: shard batch + the first
    divisible heads/channels dim; anything unmatched is replicated."""
    def spec(p, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        for pat, s in _CACHE_RULES:
            if pat.search(p):
                out = [None] * nd
                if s is None:
                    return P(*out)
                _, bdim, cands = s
                if batch_axes:
                    out[nd + bdim] = batch_axes
                for c in cands:
                    dim = nd + c
                    if shape[dim] % model_size == 0 and shape[dim] >= model_size:
                        out[dim] = "model"
                        break
                return P(*out)
        return P(*((None,) * nd))

    return map_named(spec, cache)


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def named(mesh, spec_tree):
    return map_named(lambda _, s: NamedSharding(mesh, s), spec_tree,
                     is_leaf=_is_spec)


def _is_sharding(x) -> bool:
    return x is None or isinstance(x, NamedSharding)


def place(tree, shardings):
    """``tree`` with each tensor leaf on its sharding's device (the
    counterpart of ``jax.device_put(tree, shardings)``). ``shardings``
    mirrors ``tree``, or is one :class:`NamedSharding` for every leaf; a
    None leaf of it, an abstract mesh (``meta`` slots: the production
    meshes) or a fake tensor (the dry run's stand-ins, which hold no
    storage) leaves the tensor where it is. Raises
    ``NotImplementedError`` for a mesh of several distinct devices."""
    from torch._subclasses.fake_tensor import is_fake

    def put(x, s):
        if s is None or is_fake(x):
            return x
        devices = s.mesh.distinct_devices()
        if len(devices) > 1:
            raise NotImplementedError(
                f"placing over {len(devices)} distinct devices needs "
                f"multi-card model and FSDP parallelism through "
                f"torch.distributed: ROADMAP queue 1, item 20 (mesh "
                f"{dict(s.mesh.shape)}, spec {s.spec!r})")
        if devices[0].type == "meta":        # an abstract mesh
            return x
        return x.to(devices[0])

    if _is_sharding(shardings):
        return map_named(lambda _, x: put(x, shardings), tree)
    return _zip_map(put, tree, shardings)


def shard_bytes(tree, shardings) -> int:
    """One device's bytes of ``tree``'s tensor leaves, each cut to its
    sharding's ``shard_shape`` (a None sharding: the whole leaf; host
    numbers: none)."""
    total = []

    def add(x, s):
        if isinstance(x, torch.Tensor):
            shape = x.shape if s is None else s.shard_shape(x.shape)
            total.append(math.prod(shape) * x.element_size())
        return x

    _zip_map(add, tree, shardings)
    return sum(total)


def _zip_map(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of one structure, whose
    second has NamedSharding (or None) leaves."""
    if _is_sharding(other):
        return fn(tree, other)
    if isinstance(tree, dict):
        if set(tree) != set(other):
            raise ValueError(f"tree keys {sorted(tree)} != sharding keys "
                             f"{sorted(other)}")
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(other):
            raise ValueError(f"{len(tree)} leaves against {len(other)} "
                             f"shardings")
        out = [_zip_map(fn, v, o) for v, o in zip(tree, other)]
        return out if isinstance(tree, list) else tuple(out)
    raise ValueError(f"no sharding for leaf {type(tree).__name__}")
