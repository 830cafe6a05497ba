"""The port's FSDP train step against the reference's, on the CPU: the
reference's ``launch.specs.train_setup`` jitted with its ``in_shardings``
and ``out_shardings`` on a (2, 2) host mesh of 4 forced devices
(``tests/_reference_fsdp_step.py``, a process of its own per arch), three
steps from its own init; the port's ``launch.specs.train_setup`` step on
4 gloo ranks on (2, 2), placed by its own FSDP shardings from the
reference's init checkpoint (``tests/_parallel_workers.py``'s
``reference_fsdp``): losses rtol 1e-4, every leaf of the final state
within 1e-5 (names and dtypes equal). The collectives beside each
other: the port's ranks count exactly the dry run's census of the same
step; the reference's census of its compiled step has the same keys
and differs op by op (GSPMD picks its own collectives)."""
import json
import subprocess
import sys

import numpy as np
import pytest

import _parallel_workers as W
from _parallel_workers import HERE, env, npz, spawn

ARCHS = W.FSDP_FAMILIES


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """arch -> (the reference's record and final checkpoint, the port's
    record and final checkpoint)."""
    out = tmp_path_factory.mktemp("fsdp_ref")
    ref_env = env()
    # one thread a process: six of them run beside the other test files
    ref_env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                            "--xla_cpu_multi_thread_eigen=false "
                            "intra_op_parallelism_threads=1")
    ref_env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "_reference_fsdp_step.py"), str(out),
         arch], env=ref_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for arch in ARCHS]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    port = spawn(4, out, {"fsdp": {"reference": {
        a: [str(out / a), str(out / "port" / a)] for a in ARCHS}}},
                 W.FSDP_RANK_TIMEOUT)
    return {a: (json.loads((out / a / "reference.json").read_text()),
                npz(out / a / f"ckpt_{W.FSDP_STEPS:08d}.npz"), port[0][a],
                npz(out / "port" / a / f"ckpt_{W.FSDP_STEPS:08d}.npz"))
            for a in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_step_matches_the_reference(runs, arch):
    """Both steps run the same layout on a (2, 2) mesh (the same count of
    params leaves split over "data"); three steps' losses within rtol
    1e-4 and every leaf of the final train state (params, AdamW's
    moments and count, step) within 1e-5."""
    ref, ref_state, port, port_state = runs[arch]
    assert ref["mesh"] == port["mesh"] == {"data": 2, "model": 2}
    assert ref["data_split"] == port["data_split"] > 0
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-4)
    assert set(port_state) == set(ref_state)
    for k, (v, dt) in ref_state.items():
        assert port_state[k][1] == dt, k
        np.testing.assert_allclose(port_state[k][0], v, rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_collective_census_beside_the_reference(runs, arch):
    """On (2, 2) each rank of the port's ``train_setup`` step counts
    exactly what the dry run's census of it says (rank 0's trace on fake
    tensors); the reference's census of its compiled step (its dry run's
    ``collective_bytes`` of the HLO) has the same keys. Both gather the
    data-split leaves; the reference's partitioner also picks all-to-all
    and collective-permute, and sums gradients by all-reduce where the
    port reduce-scatters them, so the two are not held equal."""
    ref, _, port, _ = runs[arch]
    want = W.dry_run_census(arch, W.FSDP_SHAPE, 2, 2)
    assert port["census"] == want
    theirs = ref["collectives"]
    assert set(theirs) == set(want) == {"bytes_by_op", "count_by_op",
                                        "total_bytes"}
    assert want["count_by_op"]["all-gather"] > 0 \
        and theirs["count_by_op"]["all-gather"] > 0
