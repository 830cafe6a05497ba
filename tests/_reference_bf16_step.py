"""The reference's hetero train step in bf16, one step from its own init,
on a (1, MP) host mesh as its train launcher builds it
(``src/repro/launch/train.py``) and on one device, and in f32 on one
device; run in a process of its own, whose MP host devices XLA_FLAGS
forces (MP 2 when not given):

    XLA_FLAGS=--xla_force_host_platform_device_count=MP JAX_PLATFORMS=cpu \\
        python tests/_reference_bf16_step.py OUT_DIR ARCH [MP]

writes the arch's init state as a checkpoint
(``OUT_DIR/ARCH/ckpt_00000000.npz``), and ``OUT_DIR/ARCH/reference.json``: each run's loss and the first moment of
AdamW after the step (0.1 x the aggregated gradient) by leaf name, and
the element types of the all-reduces of the sharded step's compiled
HLO."""
import dataclasses
import json
import re
import sys

import jax
import numpy as np

from repro import optim
from repro.checkpoint import Checkpointer
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.core import TrainState, make_hetero_train_step
from repro.core.compression import default_tier_plans
from repro.data.synthetic import make_train_batch
from repro.launch.mesh import make_host_mesh, num_batch_shards
from repro.models import get_model
from repro.models.sharding import named, param_spec_tree, set_rules


def run(arch: str, out: str, mp: int = 2) -> None:
    mesh = make_host_mesh(mp)
    set_rules({})
    shape = ShapeConfig("cli", 16, 8, "train")
    res = {"mesh": dict(mesh.shape)}
    state0 = None
    for label, dtype, sharded in (("mesh_bf16", "bfloat16", True),
                                  ("one_bf16", "bfloat16", False),
                                  ("one_f32", "float32", False)):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
        model = get_model(cfg)
        opt = optim.adamw(optim.warmup_cosine(3e-4, 20, 100))
        step_fn = make_hetero_train_step(
            model, opt, default_tier_plans(4),
            num_groups=num_batch_shards(mesh) if sharded else 1)
        state = TrainState.create(model, opt, jax.random.PRNGKey(0))
        if state0 is None:
            state0 = state
            Checkpointer(out).save(state, 0)
        batch = make_train_batch(cfg, shape, n_tiers=4, seed=0, index=0)
        if sharded:
            sh = named(mesh, param_spec_tree(state, mesh.shape["model"]))
            with mesh:
                state = jax.device_put(state, sh)
                jstep = jax.jit(step_fn, in_shardings=(sh, None),
                                out_shardings=(sh, None))
                hlo = jstep.lower(state, batch).compile().as_text()
                new, metrics = jstep(state, batch)
            res["all_reduce_types"] = sorted(set(re.findall(
                r"= \(?([a-z0-9]+)\[[^=]*? all-reduce(?:-start)?\(", hlo)))
            res["all_reduces"] = len(re.findall(r" all-reduce(?:-start)?\(",
                                                hlo))
        else:
            new, metrics = jax.jit(step_fn)(state, batch)
        m = jax.tree_util.tree_flatten_with_path(new["opt"]["m"])[0]
        res[label] = {
            "loss": float(metrics["loss"]),
            "m": {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path): np.asarray(v).tolist()
                  for path, v in m}}
    with open(f"{out}/reference.json", "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    run(sys.argv[2], f"{sys.argv[1]}/{sys.argv[2]}",
        int(sys.argv[3]) if len(sys.argv) > 3 else 2)
