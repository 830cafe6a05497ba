"""The reference's FSDP train layout, as its dry run builds it: its
``launch.specs.train_setup`` step jitted with its ``in_shardings`` and
``out_shardings`` on a (2, 2) host mesh (4 devices, which XLA_FLAGS
forces), three steps from its own init; run in a process of its own:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/_reference_fsdp_step.py OUT_DIR ARCH

writes the init state as a checkpoint (``OUT_DIR/ARCH/ckpt_00000000.npz``),
the state after the three steps (``ckpt_00000003.npz``), and
``OUT_DIR/ARCH/reference.json``: the mesh, the losses, how many
params leaves the shardings split over "data", and the compiled step's
per-device collective census (the reference dry run's
``collective_bytes`` of its HLO)."""
import json
import os
import sys

import jax

from repro import optim
from repro.checkpoint import Checkpointer
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.core import TrainState
from repro.data.synthetic import make_train_batch
from repro.launch.mesh import make_host_mesh
from repro.launch.specs import train_setup
from repro.models import get_model

STEPS = 3
SHAPE = ShapeConfig("fsdp", 16, 8, "train")


def run(arch: str, out: str) -> None:
    cfg = get_smoke_config(arch)
    mesh = make_host_mesh(2)
    step, _, (state_sh, batch_sh), out_sh = train_setup(cfg, SHAPE, mesh)
    # train_setup's optimizer, so the state has its structure
    opt = optim.adamw(optim.warmup_cosine(3e-4, 100, 10_000))
    state = TrainState.create(get_model(cfg), opt, jax.random.PRNGKey(0))
    ckpt = Checkpointer(out)
    ckpt.save(state, 0)
    losses = []
    with mesh:
        state = jax.device_put(state, state_sh)
        jstep = jax.jit(step, in_shardings=(state_sh, batch_sh),
                        out_shardings=out_sh)
        for i in range(STEPS):
            batch = make_train_batch(cfg, SHAPE, n_tiers=4, seed=0, index=i)
            state, metrics = jstep(state, batch)
            losses.append(float(metrics["loss"]))
        hlo = jstep.lower(state, batch).compile().as_text()
    ckpt.save(state, STEPS)
    # the dry run's module sets XLA_FLAGS when imported; JAX has its 4
    # devices already, so only the environment is put back
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch.dryrun import collective_bytes
    os.environ["XLA_FLAGS"] = flags
    split = sum("data" in tuple(s.spec) for s in jax.tree_util.tree_leaves(
        state_sh["params"],
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding)))
    with open(f"{out}/reference.json", "w") as f:
        json.dump({"mesh": dict(mesh.shape), "losses": losses,
                   "data_split": split,
                   "collectives": collective_bytes(hlo)}, f)


if __name__ == "__main__":
    run(sys.argv[2], f"{sys.argv[1]}/{sys.argv[2]}")
