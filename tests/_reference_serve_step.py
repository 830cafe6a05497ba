"""The reference's sharded prefill and decode, as its dry run builds
them: its ``launch.specs`` ``prefill_setup`` and ``decode_setup`` steps
jitted with their ``in_shardings`` and ``out_shardings`` on a (2, 2) and
a (1, 4) host mesh (4 devices, which XLA_FLAGS forces), every arch named
in one process:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/_reference_serve_step.py OUT_DIR ARCH [ARCH ...]

Each arch reads its inputs from ``OUT_DIR/ARCH/inputs.npz`` (the prompt
batch and the decode tokens, drawn by ``_parallel_workers.serve_inputs``)
and writes ``OUT_DIR/ARCH/ckpt_00000000.npz``, the params as deployed
(its init from key 0, compressible leaves in the compute dtype, as
``_deployed_params`` casts them), and for each model-parallel width M
``OUT_DIR/ARCH/mp{M}.npz``: the prefill's and each decode step's logits
(``logits/I``), the cache after the prefill (``prefill_cache/...``) and
after the last step (``cache/...``); and ``OUT_DIR/ARCH/reference.json``:
the meshes and the compiled prefill's and decode step's per-device
collective census (the reference dry run's ``collective_bytes`` of its
HLO)."""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.checkpoint import Checkpointer
from repro.checkpoint.checkpointer import save_pytree
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.core.compression.apply import compressible
from repro.launch.mesh import make_host_mesh
from repro.launch.specs import decode_setup, prefill_setup
from repro.models import get_model

MPS = (2, 4)                      # (2, 2) and (1, 4) over 4 devices


def _deployed(cfg, params):
    dt = jnp.dtype(cfg.dtype)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: x.astype(dt) if compressible(p, x) else x, params)


def run(arch: str, out: str, collective_bytes) -> None:
    cfg = get_smoke_config(arch)
    with np.load(f"{out}/inputs.npz") as z:
        batch = {k[6:]: jnp.asarray(z[k]) for k in z.files
                 if k.startswith("batch/")}
        toks = [jnp.asarray(z[f"toks/{i}"]) for i in range(
            sum(k.startswith("toks/") for k in z.files))]
    b = batch["tokens"].shape[0]
    t = batch["tokens"].shape[1] + (cfg.num_patches
                                    if cfg.family == "vlm" else 0)
    params = _deployed(cfg, get_model(cfg).init(jax.random.PRNGKey(0)))
    Checkpointer(out).save(params, 0)
    rec = {}
    for mp in MPS:
        mesh = make_host_mesh(mp)
        pstep, _, p_in, p_out = prefill_setup(
            cfg, ShapeConfig("p", t, b, "prefill"), mesh)
        dstep, _, d_in, d_out = decode_setup(
            cfg, ShapeConfig("d", t, b, "decode"), mesh)
        res = {}
        with mesh:
            jp = jax.jit(pstep, in_shardings=p_in, out_shardings=p_out)
            jd = jax.jit(dstep, in_shardings=d_in, out_shardings=d_out,
                         donate_argnums=())
            logits, cache = jp(params, batch)
            res["logits/0"] = logits
            res["prefill_cache"] = cache
            hlo_p = jp.lower(params, batch).compile().as_text()
            for i, tok in enumerate(toks):
                pos = jnp.int32(t + i)
                hlo_d = jd.lower(params, cache, tok, pos).compile().as_text()
                logits, cache = jd(params, cache, tok, pos)
                res[f"logits/{i + 1}"] = logits
            res["cache"] = cache
        save_pytree(jax.device_get(res), f"{out}/mp{mp}.npz")
        rec[mp] = {"mesh": dict(mesh.shape),
                   "prefill": collective_bytes(hlo_p),
                   "decode": collective_bytes(hlo_d)}
    with open(f"{out}/reference.json", "w") as f:
        json.dump(rec, f)


if __name__ == "__main__":
    # the dry run's module sets XLA_FLAGS when imported; JAX has its 4
    # devices already, so only the environment is put back
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch.dryrun import collective_bytes
    os.environ["XLA_FLAGS"] = flags
    for name in sys.argv[2:]:
        run(name, f"{sys.argv[1]}/{name}", collective_bytes)
