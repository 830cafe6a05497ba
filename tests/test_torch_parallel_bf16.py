"""The bf16 partial sums over model ranks against the reference's own
sharded bf16 step, on the CPU: the reference's hetero train step in
bf16 from its own init on a (1, 2) host mesh, as its train launcher
builds it (``tests/_reference_bf16_step.py``, a process forced to 2
host devices, one per arch), against the port's on 2 gloo ranks from
that init's checkpoint (``tests/_parallel_workers.py``)."""
import json
import subprocess
import sys

import numpy as np
import pytest

from _parallel_workers import HERE, env, spawn

ARCHS = ("llama3.2-3b", "granite-moe-1b-a400m")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """arch -> (the reference's runs: its bf16 step on (1, 2) and on one
    device, its f32 step on one device, and its compiled sharded step's
    all-reduce types; the port's bf16 step on (1, 2))."""
    out = tmp_path_factory.mktemp("bf16")
    ref_env = env()
    ref_env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    ref_env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "_reference_bf16_step.py"), str(out),
         arch], env=ref_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for arch in ARCHS]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ports = spawn(2, out, {"bf16": {a: str(out / a) for a in ARCHS}})
    return {a: (json.loads((out / a / "reference.json").read_text()),
                ports[0][a]) for a in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_step_matches_the_sharded_reference(runs, arch):
    """The reference's sharded step (XLA on the CPU) computes a row-split
    projection's partial in f32, rounds it to bf16 (the dot's type),
    all-reduces in f32 and rounds the sum once: every all-reduce of its
    compiled step is f32. The port rounds each rank's partial to bf16 and
    sums in bf16 (gloo), which for 2 ranks is the same rounding, the f32
    sum of two bf16 values being exact. So from the reference's init the
    port's (1, 2) bf16 loss lies within the reference's own bf16-vs-f32
    distance of the reference's (1, 2) bf16 loss, and its gradients
    (AdamW's first moment after the step) within twice that distance,
    leaf by leaf."""
    ref, port = runs[arch]
    assert ref["mesh"] == {"data": 1, "model": 2}
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
