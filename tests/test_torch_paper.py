"""The port's public names that mirror the reference's (``paper_splits``,
``smoke_config``, ``slice_submodel``, the ``repro_torch.core`` and
``repro_torch.fl`` exports), the paper's §6 experiment (full-batch GD on
the 5-layer MLP) against the reference's curve, and the train
launcher's ``--ckpt-dir``: a run resumed from a checkpoint continues the
uninterrupted one bit for bit."""
import os

import jax
import numpy as np
import pytest
import torch

import repro.fl as JFL
from repro.configs import paper_mlp as j_cfg
from repro.core.compression import slice_submodel as j_slice_submodel
from repro.data import paper_splits as j_paper_splits
from repro.models import mlp as jmlp
import repro_torch.core as TC
import repro_torch.fl as T
from repro_torch.configs import paper_mlp as t_cfg
from repro_torch.data import paper_splits
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import train as train_mod
from repro_torch.models import mlp as tmlp

torch.set_num_threads(1)

EPOCHS = 80


def test_paper_splits_shapes_dtypes_and_balance():
    train, val, test = paper_splits(torch.Generator().manual_seed(0), 1000)
    for d, n in ((train, 1000), (val, 1000), (test, 1000)):
        assert d["x"].shape == (n, 5) and d["x"].dtype == torch.float32
        assert d["y"].shape == (n,) and d["y"].dtype == torch.int64
        assert 0.45 < d["y"].float().mean().item() < 0.55
        for c, sign in ((0, -1.0), (1, 1.0)):
            mu = d["x"][d["y"] == c].mean(0)
            assert torch.all((mu - sign).abs() < 0.15)
    again = paper_splits(torch.Generator().manual_seed(0), 1000)
    assert torch.equal(again[2]["x"], test["x"])
    assert not torch.equal(train["x"], val["x"])


def test_smoke_config_matches_reference():
    assert t_cfg.smoke_config().__dict__ == j_cfg.smoke_config().__dict__
    assert t_cfg.config().__dict__ == j_cfg.config().__dict__


@pytest.mark.parametrize("width", [1.0, 0.5, 0.3])
def test_slice_submodel_matches_reference(width):
    j_params = jmlp.init(jax.random.PRNGKey(3), j_cfg.config())
    sub, spec = T.slice_submodel(
        params_from_numpy(jax.tree.map(np.asarray, j_params)), width)
    j_sub, j_spec = j_slice_submodel(j_params, width)
    assert spec.slices == j_spec.slices and spec.shapes == j_spec.shapes
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, j_sub)),
                    jax.tree.leaves(params_to_numpy(sub))):
        assert np.array_equal(a, b)


def test_public_names_match_reference():
    """What ``repro.fl`` exports for faults, checkpoints and sub-models,
    and ``repro.core``'s step API, exist in the port."""
    for name in ("FaultPolicy", "Checkpointer", "save_pytree", "load_pytree",
                 "latest_run_step", "save_run_state", "restore_run_state",
                 "slice_submodel"):
        assert hasattr(JFL, name) and hasattr(T, name), name
    for name in ("hetero_aggregate", "TrainState", "make_hetero_train_step",
                 "make_serve_step", "make_prefill_step"):
        assert callable(getattr(TC, name)), name


def _gd_curve(params: dict, train: dict, val: dict, lr: float = 1.0):
    """``examples/paper_mlp_repro.py``'s loop in the port: one step, then
    EPOCHS steps each followed by the validation accuracy."""
    def step(p):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        g = torch.autograd.grad(tmlp.loss_fn(leaves, train),
                                list(leaves.values()))
        return {k: v.detach() - lr * gk for (k, v), gk in zip(p.items(), g)}
    params = step(params)
    accs = []
    for _ in range(EPOCHS):
        params = step(params)
        accs.append(tmlp.accuracy(params, val["x"], val["y"]).item())
    return accs


def test_paper_gd_curve_matches_reference():
    """§6, n_train 1000, f32, lr 1.0: the reference's splits and init
    carried across, the port's val-accuracy curve within 1e-3 of the
    reference's at every epoch; the same run in float64 in the port
    alone reaches the paper's level."""
    j_train, j_val, _ = j_paper_splits(jax.random.PRNGKey(0), 1000)
    j_p0 = jmlp.init(jax.random.PRNGKey(1), j_cfg.config())

    @jax.jit
    def j_step(p):
        g = jax.grad(jmlp.loss_fn)(p, j_train)
        return jax.tree.map(lambda p, g: p - 1.0 * g, p, g)
    p = j_step(j_p0)
    ref = []
    for _ in range(EPOCHS):
        p = j_step(p)
        ref.append(float(jmlp.accuracy(p, j_val["x"], j_val["y"])))

    def tensors(d, dtype):
        return {"x": torch.tensor(np.asarray(d["x"]), dtype=dtype),
                "y": torch.tensor(np.asarray(d["y"]), dtype=torch.int64)}
    p0 = params_from_numpy(jax.tree.map(np.asarray, j_p0))
    got = _gd_curve(p0, tensors(j_train, torch.float32),
                    tensors(j_val, torch.float32))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    f64 = _gd_curve({k: v.double() for k, v in p0.items()},
                    tensors(j_train, torch.float64),
                    tensors(j_val, torch.float64))
    assert max(f64) >= 0.95 and max(ref) >= 0.95


def test_train_checkpoint_resume_is_bitwise(tmp_path, capsys):
    """``--ckpt-dir`` / ``--ckpt-every 2`` on the smoke config: a run
    whose last checkpoint is step 2 (what a run killed after step 2
    leaves) resumes there, and steps 3-4 reproduce the uninterrupted
    run's losses and final params bit for bit."""
    d = str(tmp_path / "ckpt")
    args = ["--arch", "llama3.2-3b", "--smoke", "--steps", "4",
            "--batch", "4", "--seq", "16", "--warmup", "2", "--device", "cpu",
            "--log-every", "1", "--ckpt-dir", d, "--ckpt-every", "2"]
    full = train_mod.main(args)
    assert full["start"] == 0 and len(full["losses"]) == 4
    assert sorted(os.listdir(d)) == ["ckpt_00000002.npz", "ckpt_00000004.npz"]
    os.remove(os.path.join(d, "ckpt_00000004.npz"))
    res = train_mod.main(args)
    assert "restored step 2" in capsys.readouterr().out
    assert res["start"] == 2 and res["losses"] == full["losses"][2:]
    assert res["tier_losses"] == full["tier_losses"][2:]
    a, b = full["state"], res["state"]
    assert int(b["step"]) == 4
    assert all(torch.equal(a["params"][k], b["params"][k])
               for k in a["params"])
    assert all(torch.equal(a["opt"][s][k], b["opt"][s][k])
               for s in ("m", "v") for k in a["params"])
