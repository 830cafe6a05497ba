"""Every family's prefill and decode over ranks against the reference's
sharded ones, on the CPU: the reference's ``launch.specs``
``prefill_setup`` and ``decode_setup`` steps jitted with their
``in_shardings`` and ``out_shardings`` on a (2, 2) and a (1, 4) host mesh
of 4 forced devices (``tests/_reference_serve_step.py``, one process for
every arch), a prompt then three decode steps from its own deployed
params; the port's same setups' steps on 4 gloo ranks on the same meshes
from those params and inputs (``tests/_parallel_workers.py``'s
``reference_serve``): every call's logits within 1e-5 of the
reference's (the recurrent families 5e-5), each rank's cache after the
prefill and after the last step within that of the reference cache's
block as ``cache_spec_tree`` places it, ``slot_pos`` exact. The two
programs' collective censuses are printed beside each other: GSPMD picks
its own collectives, so they are not held equal."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import _parallel_workers as W
from _parallel_workers import HERE, env, npz, spawn
from repro_torch.checkpoint.checkpointer import named_leaves
from repro_torch.launch import specs
from repro_torch.launch.mesh import census_mesh
from repro_torch.models.sharding import cache_spec_tree, named

ARCHS = W.SERVE_ARCHS
MPS = (2, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """arch -> (the reference's record and results by M, the port's
    ranks' results by M)."""
    out = tmp_path_factory.mktemp("serve_ref")
    for arch in ARCHS:
        batch, toks = W.serve_inputs(W.config(arch))
        (out / arch).mkdir()
        np.savez(out / arch / "inputs.npz",
                 **{f"batch/{k}": v.numpy() for k, v in batch.items()},
                 **{f"toks/{i}": t.numpy() for i, t in enumerate(toks)})
    ref_env = env()
    ref_env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                            "--xla_cpu_multi_thread_eigen=false "
                            "intra_op_parallelism_threads=1")
    ref_env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, str(HERE / "_reference_serve_step.py"),
                        str(out), *ARCHS], env=ref_env, capture_output=True,
                       text=True, timeout=400)
    assert r.returncode == 0, r.stderr[-3000:]
    port = spawn(4, out, {"serve_ref": {a: str(out / a) for a in ARCHS}})
    return {a: ({mp: npz(out / a / f"mp{mp}.npz") for mp in MPS},
                json.loads((out / a / "reference.json").read_text()),
                [res[a] for res in port]) for a in ARCHS}


def _blocks(tree: dict, dp: int, mp: int, rank: int) -> dict:
    """The reference's cache (name -> array) cut to ``rank``'s blocks by
    ``cache_spec_tree`` on the (dp, mp) mesh (a census mesh answering for
    the rank)."""
    mesh = W.abstract_mesh(dp, mp)
    whole = {k: torch.from_numpy(v) for k, v in tree.items()}
    sh = cache_spec_tree(whole, specs._batch_spec(mesh, W.SERVE_B), mp)
    cut = named(census_mesh(mesh, rank), sh)
    return {k: cut[k].block(v) for k, v in whole.items()}


@pytest.mark.parametrize("mp", MPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_the_sharded_reference(runs, arch, mp):
    """On (4 / mp, mp): the logits of the prefill and of each decode step,
    and each rank's blocks of the cache after the prefill and after the
    last step, against the reference's jitted setups' steps."""
    refs, rec, ranks = runs[arch]
    ref = refs[mp]
    dp = 4 // mp
    assert rec[str(mp)]["mesh"] == {"data": dp, "model": mp}
    bar = 5e-5 if arch in W.RECURRENT else 1e-5
    for rank, res in enumerate(ranks):
        got = res[mp]
        for i, logits in enumerate(got["logits"]):
            np.testing.assert_allclose(logits.numpy(), ref[f"logits/{i}"][0],
                                       rtol=0, atol=bar,
                                       err_msg=f"logits {i}")
        for key in ("prefill_cache", "cache"):
            want = _blocks({k[len(key) + 1:]: v for k, (v, _) in ref.items()
                            if k.startswith(key + "/")}, dp, mp, rank)
            mine = dict(named_leaves(got[key]))
            assert set(mine) == set(want), key
            for name, w in want.items():
                x = mine[name]
                assert x.shape == w.shape, (key, name)
                if name.endswith("slot_pos"):
                    assert torch.equal(x, w.to(x.dtype)), (key, name)
                else:
                    torch.testing.assert_close(x, w.to(x.dtype), rtol=0,
                                               atol=bar, msg=f"{key} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_census_beside_the_reference(runs, arch):
    """Both censuses of each mesh's prefill and decode step, per device:
    the port's (every rank's count, the dry run's census) and the
    reference's (its compiled steps' HLO), printed beside each other.
    Both have the reference's keys and move bytes; they differ op by op
    (GSPMD reshards with all-to-all and collective-permute)."""
    _, rec, ranks = runs[arch]
    prefill, decode = W.serve_shapes()
    for mp in MPS:
        for mode, shape, calls in (("prefill", prefill, slice(0, 1)),
                                   ("decode", decode, slice(1, None))):
            want = W.dry_run_census(arch, shape, 4 // mp, mp)
            for res in ranks:
                assert all(c == want for c in res[mp]["census"][calls])
            theirs = rec[str(mp)][mode]
            print(f"{arch} ({4 // mp}, {mp}) {mode}: port "
                  f"{json.dumps(want)}; reference {json.dumps(theirs)}")
            assert set(theirs) == set(want)
            assert want["total_bytes"] > 0 and theirs["total_bytes"] > 0
