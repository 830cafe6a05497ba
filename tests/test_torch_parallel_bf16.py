"""The bf16 partial sums over model ranks against the reference's own
sharded bf16 step, on the CPU: the reference's hetero train step in
bf16 from its own init on a (1, 2) host mesh, as its train launcher
builds it (``tests/_reference_bf16_step.py``, a process forced to 2
host devices, one per arch), against the port's on 2 gloo ranks from
that init's checkpoint (``tests/_parallel_workers.py``); and llama's on
a (1, 4) mesh (4 host devices) against 4 gloo ranks."""
import json
import subprocess
import sys

import numpy as np
import pytest

from _parallel_workers import HERE, env, spawn

ARCHS = ("llama3.2-3b", "granite-moe-1b-a400m")
ARCH_4 = "llama3.2-3b"          # held on (1, 4) too


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(arch, model ranks) -> (the reference's runs: its bf16 step on
    (1, mp) and on one device, its f32 step on one device, and its
    compiled sharded step's all-reduce types; the port's bf16 step on
    (1, mp))."""
    out = tmp_path_factory.mktemp("bf16")
    jobs = [(a, 2, out) for a in ARCHS] + [(ARCH_4, 4, out / "mp4")]
    procs = []
    for arch, mp, d in jobs:
        ref_env = env()
        ref_env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={mp}"
        ref_env["JAX_PLATFORMS"] = "cpu"
        procs.append(subprocess.Popen(
            [sys.executable, str(HERE / "_reference_bf16_step.py"), str(d),
             arch, str(mp)], env=ref_env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ports = {2: spawn(2, out, {"bf16": {a: str(out / a) for a in ARCHS}}),
             4: spawn(4, out / "mp4",
                      {"bf16": {ARCH_4: str(out / "mp4" / ARCH_4)}})}
    return {(a, mp): (json.loads((d / a / "reference.json").read_text()),
                      ports[mp][0][a]) for a, mp, d in jobs}


def _check(ref: dict, port: dict, mp: int) -> None:
    assert ref["mesh"] == {"data": 1, "model": mp}
    assert ref["all_reduce_types"] == ["f32"] and ref["all_reduces"] > 0
    noise = abs(ref["one_bf16"]["loss"] - ref["one_f32"]["loss"])
    assert abs(port["loss"] - ref["mesh_bf16"]["loss"]) <= noise
    names = {k.replace(".", "/"): k for k in port["m"]}
    assert set(names) == set(ref["mesh_bf16"]["m"])
    for k, v in ref["mesh_bf16"]["m"].items():
        own = np.abs(np.asarray(ref["one_bf16"]["m"][k])
                     - np.asarray(ref["one_f32"]["m"][k])).max()
        mine = port["m"][names[k]].numpy()
        assert np.abs(mine - np.asarray(v)).max() <= 2 * own, k


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_step_matches_the_sharded_reference(runs, arch):
    """The reference's sharded step (XLA on the CPU) computes a row-split
    projection's partial in f32, rounds it to bf16 (the dot's type),
    all-reduces in f32 and rounds the sum once: every all-reduce of its
    compiled step is f32. The port's sums round once too
    (``parallel.sum_over``: over 2 ranks gloo's bf16 sum, the same
    bits; over more, in f32). So from the reference's init the port's (1, 2) bf16
    loss lies within the reference's own bf16-vs-f32 distance of the
    reference's (1, 2) bf16 loss, and its gradients (AdamW's first
    moment after the step) within twice that distance, leaf by leaf."""
    _check(*runs[arch, 2], 2)


def test_bf16_step_matches_the_sharded_reference_4(runs):
    """As above for llama3.2-3b's smoke config on a (1, 4) mesh (q on its
    4 heads, k / v on the head_dim fallback), where a bf16 sum through
    gloo would round two more additions than the reference: the
    reference's all-reduces there are f32, and the port's loss and
    gradients lie within its own bf16-vs-f32 distance (twice it for the
    gradients) of its sharded bf16 step's."""
    _check(*runs[ARCH_4, 4], 4)
