"""Port parity for meshes and shardings (``repro_torch.launch.mesh``,
``repro_torch.models.sharding``), on the CPU: the port's PartitionSpecs
equal the reference's leaf for leaf (every arch at its full config, the
train state with its Adam moments, several model-axis sizes and FSDP;
the decode caches), the seven cases of the reference's
``tests/test_sharding.py`` hold on the port, the meshes have the
reference's shapes and axes, ``place`` refuses several distinct devices,
and a one-device mesh changes no bit of the train step or launcher.

The reference's full-config trees come from ``jax.eval_shape``, the
port's from fake tensors; neither allocates the params. The reference's
production meshes need 512 JAX devices, which only a fresh process can
ask for, so its mesh shapes come from one subprocess."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import optim as j_optim
from repro.configs import get_config as j_config
from repro.core import TrainState as JTrainState
from repro.models import get_model as j_model
from repro.models import sharding as JS
from repro_torch import optim
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core.compression import default_tier_plans
from repro_torch.core.steps import TrainState, make_hetero_train_step
from repro_torch.data.synthetic import make_train_batch
from repro_torch.configs import ShapeConfig
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import (Mesh, batch_axes, make_host_mesh,
                                     make_production_mesh, num_batch_shards)
from repro_torch.launch.specs import fake_mode
from repro_torch.models import get_model
from repro_torch.models.sharding import (P, NamedSharding, cache_spec_tree,
                                         hint, make_activation_rules, named,
                                         param_spec_tree, place, shard_bytes)

ROOT = Path(__file__).resolve().parent.parent
MODEL = 16
CPU = torch.device("cpu")
CACHE_ARCHS = ["llama3.2-3b", "qwen2.5-32b", "xlstm-1.3b", "zamba2-2.7b",
               "whisper-tiny"]

torch.set_num_threads(1)


def _ref_specs(tree) -> dict:
    """The reference's spec tree as {leaf path: spec entries}."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JS.P))[0]
    return {JS._path_str(path): _entries(s) for path, s in flat}


def _port_specs(tree) -> dict:
    from repro_torch.checkpoint.checkpointer import map_named
    out = {}
    map_named(lambda name, s: out.__setitem__(name, _entries(s)), tree,
              is_leaf=lambda x: isinstance(x, P))
    return out


def _entries(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


@pytest.fixture(scope="module")
def states():
    """arch -> (the reference's train state as ShapeDtypeStructs, the
    port's as fake tensors), both at the full config under AdamW."""
    out = {}
    for arch in ARCHS:
        jm = j_model(j_config(arch))
        jopt = j_optim.adamw(1e-3)
        ref = jax.eval_shape(lambda k: JTrainState.create(jm, jopt, k),
                             jax.random.PRNGKey(0))
        with fake_mode():
            mine = TrainState.create(get_model(get_config(arch)),
                                     optim.adamw(1e-3), 0, device="cpu")
        out[arch] = ref, mine
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, states):
    """Every leaf's spec at model sizes 16, 8 and 1, the params alone and
    the whole train state (Adam's m and v, the counters), and with the
    data axes' FSDP sharding on top."""
    ref, mine = states[arch]
    for size in (16, 8, 1):
        want = _ref_specs(JS.param_spec_tree(ref["params"], size))
        got = _port_specs(param_spec_tree(mine["params"], size))
        assert got == want, (arch, size)
        assert _port_specs(param_spec_tree(mine, size)) == \
            _ref_specs(JS.param_spec_tree(ref, size))
    fsdp = (("data",), 16)
    assert _port_specs(param_spec_tree(mine, MODEL, fsdp)) == \
        _ref_specs(JS.param_spec_tree(ref, MODEL, fsdp))
    assert len(_port_specs(param_spec_tree(mine, MODEL))) == \
        3 * len(mine["params"]) + 2


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_equal_reference(arch):
    ref = jax.eval_shape(lambda: j_model(j_config(arch)).init_cache(128, 1024))
    with fake_mode():
        mine = get_model(get_config(arch)).init_cache(128, 1024, device="cpu")
    for axes, size in ((("data",), MODEL), (("pod", "data"), 8), (None, 1)):
        assert _port_specs(cache_spec_tree(mine, axes, size)) == \
            _ref_specs(JS.cache_spec_tree(ref, axes, size)), (arch, axes)


# ------------------------------------- the reference's tests/test_sharding.py

def _check_legal(tree, specs):
    leaves, n_sharded = {}, 0
    from repro_torch.checkpoint.checkpointer import map_named
    map_named(lambda name, x: leaves.__setitem__(name, x), tree)
    spec = _port_specs(specs)
    assert list(spec) == list(leaves)
    for name, leaf in leaves.items():
        for dim, ax in enumerate(spec[name]):
            if ax == "model":
                n_sharded += 1
                assert leaf.shape[dim] % MODEL == 0, \
                    f"{name}: dim {dim} ({leaf.shape}) not divisible"
    return n_sharded


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_legal_and_nontrivial(arch, states):
    params = states[arch][1]["params"]
    n = _check_legal(params, param_spec_tree(params, MODEL))
    # the bulk of parameters must actually be sharded
    assert n >= len(params) // 3, f"only {n} leaves sharded"


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_legal(arch):
    with fake_mode():
        cache = get_model(get_config(arch)).init_cache(128, 1024,
                                                       device="cpu")
    _check_legal(cache, cache_spec_tree(cache, ("data",), MODEL))


def test_opt_state_specs_mirror_params(states):
    """adam m/v get the same specs as their params (path-suffix matching)."""
    specs = param_spec_tree(states["llama3.2-3b"][1], MODEL)
    sp = specs["params"]["layers.mlp.wi.w"]
    sm = specs["opt"]["m"]["layers.mlp.wi.w"]
    sv = specs["opt"]["v"]["layers.mlp.wi.w"]
    assert sp == sm == sv
    assert "model" in tuple(x for x in sp if x)


def test_nondivisible_heads_fall_back_to_head_dim(states):
    """llama3.2: 24 q-heads / 8 kv-heads on a 16-wide axis -> hd sharded."""
    specs = param_spec_tree(states["llama3.2-3b"][1]["params"], MODEL)
    assert specs["layers.attn.wq.w"] == P(None, None, None, "model")
    assert specs["layers.attn.wk.w"] == P(None, None, None, "model")


def test_divisible_heads_shard_heads(states):
    specs = param_spec_tree(states["deepseek-7b"][1]["params"], MODEL)
    assert specs["layers.attn.wq.w"] == P(None, None, "model", None)


def test_odd_vocab_replicates_vocab_dim(states):
    specs = param_spec_tree(states["granite-3-2b"][1]["params"], MODEL)
    assert specs["embed"] == P(None, "model")  # falls back to d_model


def test_experts_sharded(states):
    specs = param_spec_tree(states["qwen3-moe-30b-a3b"][1]["params"], MODEL)
    assert specs["layers.moe.we_g"] == P(None, "model", None, None)
    assert specs["layers.moe.router.w"] == P(None, None, None)


# --------------------------------------------------------------- meshes

_REFERENCE_MESHES = """
import json
from repro.launch import dryrun  # sets XLA_FLAGS: 512 host devices
from repro.launch.mesh import (batch_axes, make_host_mesh,
                               make_production_mesh, num_batch_shards)
meshes = {"single": make_production_mesh(),
          "multi": make_production_mesh(multi_pod=True),
          **{f"host{mp}": make_host_mesh(mp) for mp in (1, 2, 3, 16, 1000)}}
print(json.dumps({k: [dict(m.shape), list(m.axis_names), list(batch_axes(m)),
                      num_batch_shards(m)] for k, m in meshes.items()}))
"""


@pytest.fixture(scope="module")
def reference_meshes() -> dict:
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REFERENCE_MESHES], env=env,
                         check=True, capture_output=True, text=True,
                         timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _describe(m) -> list:
    return [dict(m.shape), list(m.axis_names), list(batch_axes(m)),
            num_batch_shards(m)]


def test_meshes_match_reference(reference_meshes):
    """The production meshes, and host meshes over 512 devices at several
    model-parallel widths (the reference's host has 512 forced devices;
    the port's is given 512 CPU slots)."""
    assert _describe(make_production_mesh()) == reference_meshes["single"]
    assert _describe(make_production_mesh(multi_pod=True)) == \
        reference_meshes["multi"]
    for mp in (1, 2, 3, 16, 1000):
        assert _describe(make_host_mesh(mp, devices=[CPU] * 512)) == \
            reference_meshes[f"host{mp}"], mp
    m = make_production_mesh(multi_pod=True)
    assert m.size == 512 and m.devices.shape == (2, 16, 16)
    assert m.distinct_devices() == [torch.device("meta")]


def test_host_mesh_on_one_device_is_one_by_one():
    """The one-card case: --model-parallel 2 on one device is a (1, 1)
    mesh, as the reference's launcher makes on one device."""
    for mp in (1, 2, 8):
        m = make_host_mesh(mp, devices=[CPU])
        assert dict(m.shape) == {"data": 1, "model": 1}
        assert num_batch_shards(m) == 1 and batch_axes(m) == ("data",)


def test_host_mesh_needs_devices_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        make_host_mesh(2)


def test_partition_spec_and_shard_shape():
    assert P(None, "model") == (None, "model")
    assert repr(P(None, ("pod", "data"))) == "P(None, ('pod', 'data'))"
    m = make_production_mesh(multi_pod=True)
    s = NamedSharding(m, P(("pod", "data"), None, "model"))
    assert s.shard_shape((64, 3, 32, 5)) == (2, 3, 2, 5)
    with pytest.raises(ValueError, match="does not divide"):
        s.shard_shape((48, 3, 32))
    rules = make_activation_rules(m, ("pod", "data"), vocab_ok=False)
    assert rules["logits"].spec == P(("pod", "data"), None, None)
    x = torch.ones(2)
    assert hint(x, "act_btd") is x


def test_place_moves_leaves_to_the_one_device():
    """``[cpu] * 4`` is one distinct device: every leaf lands there with
    its values, and the per-device bytes follow the specs."""
    mesh = make_host_mesh(2, devices=[CPU] * 4)
    params = {"embed": torch.arange(64.0).reshape(16, 4),
              "layers.mlp.wi.w": torch.ones(3, 4, 8),
              "final_norm": torch.ones(4)}
    sh = named(mesh, param_spec_tree(params, mesh.shape["model"]))
    out = place(params, sh)
    assert all(torch.equal(out[k], params[k]) for k in params)
    assert shard_bytes(params, sh) == (16 * 4 // 2 + 3 * 4 * 8 // 2 + 4) * 4
    assert place({"a": [params["embed"]]}, NamedSharding(mesh, P()))["a"][0] \
        .device == CPU


def test_place_refuses_several_distinct_devices():
    mesh = Mesh(np.array([[CPU], [torch.device("meta")]], dtype=object),
                ("data", "model"))
    with pytest.raises(NotImplementedError, match="item 20"):
        place({"w": torch.ones(2, 2)}, named(mesh, {"w": P(None, None)}))
    # the abstract production mesh places nothing
    w = torch.ones(2)
    assert place({"w": w}, NamedSharding(make_production_mesh(), P()))["w"] \
        is w


# ---------------------------------------------- one device changes no bit

def test_acc_shardings_on_one_device_is_bitwise():
    cfg = get_smoke_config("llama3.2-3b")
    model, opt = get_model(cfg), optim.adamw(1e-3)
    state = TrainState.create(model, opt, 0, device="cpu")
    batch = make_train_batch(cfg, ShapeConfig("t", 16, 8, "train"),
                             n_tiers=4, seed=3)
    mesh = make_host_mesh(1, devices=[CPU] * 2)
    acc_sh = named(mesh, param_spec_tree(state["params"], 1))
    plain = make_hetero_train_step(model, opt, default_tier_plans(4))
    placed = make_hetero_train_step(model, opt, default_tier_plans(4),
                                    acc_shardings=acc_sh)
    a, ma = plain(state, batch)
    b, mb = placed(state, batch)
    assert torch.equal(ma["loss"], mb["loss"])
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
        assert torch.equal(a["opt"]["v"][k], b["opt"]["v"][k]), k


def test_launcher_model_parallel_two_is_bitwise_one(capsys):
    """--model-parallel 2 on the one CPU device is a (1, 1) mesh: the
    losses and the final params are the run at 1, bit for bit."""
    argv = ["--arch", "granite-3-2b", "--smoke", "--steps", "2", "--batch",
            "4", "--seq", "16", "--device", "cpu", "--log-every", "1"]
    one = train_mod.main(argv + ["--model-parallel", "1"])
    two = train_mod.main(argv + ["--model-parallel", "2"])
    assert one["losses"] == two["losses"]
    for k, v in one["state"]["params"].items():
        assert torch.equal(v, two["state"]["params"][k]), k
    assert "mesh={'data': 1, 'model': 1}" in capsys.readouterr().out
