"""The port's example scripts (``repro_torch.examples``) against the
reference's library calls that its ``examples/*.py`` make, on the same
inputs carried across through ``repro_torch.interop``, at small sizes on
the CPU: quickstart's scan run, hetero_fl_sim's ``run`` lines (per
client, cohort, deadline drop, async), its census lines and labels,
paper_mlp_repro's GD curves, serve_quantized's decode per tier and
train_100m's config and first steps. Then each module's ``main`` at a
small size, and its refusal to run without a GPU unless told the CPU.

The reference's scripts do their work at import, so they are never
imported here: their calls are made from the library, and hetero_fl_sim's
labels are read from its source with ``ast``."""
import ast
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fl as J
from repro import optim as jopt
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.paper_mlp import config as j_mlp_config
from repro.core import compression as JC
from repro.core.steps import compress_for_serving as j_compress
from repro.core.steps import make_hetero_train_step as j_hetero_step
from repro.core.steps import make_serve_step as j_serve_step
from repro.data import make_gaussian_dataset as j_gaussian
from repro.data import paper_splits as j_paper_splits
from repro.data.synthetic import TokenStream as JStream
from repro.models import get_model as j_get_model
from repro.models import mlp as jmlp
import repro_torch.fl as T
from repro_torch import optim as topt
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.core.compression import DEVICE_TIERS
from repro_torch.examples import (hetero_fl_sim, paper_mlp_repro,
                                  quickstart, serve_quantized, train_100m)
from repro_torch.configs.paper_mlp import config as t_mlp_config
from repro_torch.interop import (params_from_numpy, params_to_numpy,
                                 shards_from_numpy)
from repro_torch.launch.specs import fake_mode
from repro_torch.models import get_model
from repro_torch.models import mlp as tmlp

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY0 = jax.random.PRNGKey(0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_inputs(port_sc):
    """The reference's twin of a port scenario (through the JSON wire
    format), its default init (``PRNGKey(0)``) and its fleet's shards."""
    jsc = J.FLScenario.from_dict(json.loads(json.dumps(port_sc.to_dict())))
    params = jmlp.init(KEY0, j_mlp_config())
    shards = [_np(c.data) for c in jsc.fleet.build_clients()]
    return jsc, params, shards


# ---------------------------------------------------------- quickstart

def test_quickstart_matches_reference():
    """3 rounds of the quickstart scenario through the port's ``scan``
    engine against the reference's ``simulate(engine="scan")``, its
    params and shards carried across: the tier counts equal, losses at
    rtol 1e-5, every round's Eq. (1) wall time (the scan engines'
    device-side f32 max, which the eager loops' host float64 differs
    from in the 9th digit) and upload bytes and the simulated time
    exactly."""
    jsc, params, shards = _ref_inputs(quickstart.SCENARIO)
    assert quickstart.tier_counts(quickstart.SCENARIO) == \
        {t: c for (t, _), c in jsc.fleet.counts().items()}
    ref = J.simulate(jsc, 3, params=params, shards=shards, engine="scan")
    got = quickstart.run(quickstart.SCENARIO, 3, device="cpu",
                         params=params_from_numpy(_np(params)),
                         shards=shards_from_numpy(shards))
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-5)
    assert [(r.step, r.round_wall_time, r.total_upload_bytes)
            for r in got.records] == \
        [(r.step, r.round_wall_time, r.total_upload_bytes)
         for r in ref.records]
    assert got.sim_time == ref.sim_time
    assert got.summary()["total_upload_bytes"] == \
        ref.summary()["total_upload_bytes"]


# ------------------------------------------------------- hetero_fl_sim

def _ref_line(res, scenario, val) -> dict:
    """The reference script's ``run`` values from its RunResult."""
    rec = res.final
    out = {"loss": rec.loss,
           "val_acc": float(jmlp.accuracy(res.params, val["x"], val["y"]))}
    if rec.t is not None:
        out.update(virtual_t=rec.t, staleness_mean=rec.staleness_mean,
                   staleness_max=rec.staleness_max)
    elif rec.n_participants is not None:
        out.update(round_wall=rec.round_wall_time,
                   participants=rec.n_participants,
                   n_clients=scenario.fleet.n_clients, dropped=rec.n_dropped)
    else:
        out.update(round_wall=rec.round_wall_time,
                   upload_kB=rec.total_upload_bytes / 1e3)
    return out


HETERO_CASES = {label: sc for label, sc in (
    hetero_fl_sim.CLIENT[0], hetero_fl_sim.COHORT[1],
    hetero_fl_sim.COHORT[2], hetero_fl_sim.ASYNC[1])}


@pytest.mark.parametrize("label", list(HETERO_CASES))
def test_hetero_run_matches_reference(label, capsys):
    """``run(...)`` for 3 rounds (windows) of a per-client, a
    participation, a ``SyncDrop`` and an async scenario of the script,
    the reference's params, shards and validation set (``PRNGKey(9)``)
    carried across: loss at rtol 1e-5, val_acc within 1/1000, every
    other field of the line exactly; the printed line names the run."""
    sc = HETERO_CASES[label]
    jsc, params, shards = _ref_inputs(sc)
    jval = j_gaussian(jax.random.PRNGKey(9), 1000)
    val = {"x": torch.tensor(np.asarray(jval["x"])),
           "y": torch.tensor(np.asarray(jval["y"]).astype(np.int64))}
    want = _ref_line(J.simulate(jsc, 3, params=params, shards=shards), jsc,
                     jval)
    got = hetero_fl_sim.run(label, sc, rounds=3, val=val, device="cpu",
                            params=params_from_numpy(_np(params)),
                            shards=shards_from_numpy(shards))
    assert capsys.readouterr().out.startswith(f"{label:28s} loss=")
    assert set(got) == set(want) | {"result", "seconds"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert abs(got["val_acc"] - want["val_acc"]) <= 1e-3
    assert {k: got[k] for k in want if k not in ("loss", "val_acc")} == \
        {k: want[k] for k in want if k not in ("loss", "val_acc")}


def test_hetero_census_lines_match_reference():
    """The masked and width-sliced census lines: the reference script's
    f-string over the reference's ``scenario_census``, character for
    character."""
    for name, sc in (("masked", hetero_fl_sim.MASKED),
                     ("width-sliced", hetero_fl_sim.WIDTH)):
        cen = J.scenario_census(_ref_inputs(sc)[0])
        low = next(r for r in cen["tiers"] if r["tier"] == "low")
        want = (f"  {name:12s} per-round upload "
                f"{cen['total_upload_bytes_per_round'] / 1e3:6.1f}kB   "
                f"low-tier T_local={low['T_local'] * 1e3:.3f}ms "
                f"payload={low['payload_bytes']:.0f}B")
        assert hetero_fl_sim.census_line(name, T.scenario_census(sc)) == want


def test_async_jitter_line_on_the_ports_draw_is_the_references():
    """The one line of the script whose val_acc falls below 0.97 on the
    port's own draw (data, init and validation set from its
    generators), ``async buffer=2 + jitter`` at the script's 60 windows:
    the reference run on that same draw, carried across, lands on the
    same loss (rtol 1e-5) and val_acc (within 1/1000), 0.965. The draw
    decides it, not the port; on the reference's draw both give 0.986.
    ``chip_smoke.py`` holds that line at this value less 0.01."""
    label, sc = hetero_fl_sim.ASYNC[1]
    val = hetero_fl_sim.validation_set("cpu")
    got = hetero_fl_sim.run(label, sc, rounds=hetero_fl_sim.ROUNDS, val=val,
                            device="cpu")
    shards = [{"x": c.data["x"].numpy(),
               "y": c.data["y"].numpy().astype(np.int32)}
              for c in sc.fleet.build_clients()]
    p0 = params_to_numpy(tmlp.init(torch.Generator().manual_seed(0),
                                   t_mlp_config()))
    ref = J.simulate(_ref_inputs(sc)[0], hetero_fl_sim.ROUNDS, params=p0,
                     shards=shards)
    ref_acc = float(jmlp.accuracy(ref.params, jnp.asarray(val["x"].numpy()),
                                  jnp.asarray(val["y"].numpy())))
    np.testing.assert_allclose(got["loss"], ref.final.loss, rtol=1e-5)
    assert abs(got["val_acc"] - ref_acc) <= 1e-3
    assert abs(got["val_acc"] - 0.965) <= 1e-3


def _reference_run_labels() -> list[str]:
    """The first string argument of every ``run(...)`` call in the
    reference's ``examples/hetero_fl_sim.py``, in source order."""
    tree = ast.parse(open(os.path.join(ROOT, "examples",
                                       "hetero_fl_sim.py")).read())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "run"]
    calls.sort(key=lambda n: (n.lineno, n.col_offset))
    return [c.args[0].value for c in calls]


def test_hetero_main_runs_the_reference_labels(monkeypatch, capsys):
    """``main(["--device", "cpu"])`` at 1 round: its run lines carry the
    reference script's labels in its order (11), then the two census
    lines and the scan block, whose eager and scan params are bitwise
    equal on the CPU."""
    monkeypatch.setattr(hetero_fl_sim, "ROUNDS", 1)
    out = hetero_fl_sim.main(["--device", "cpu"])
    labels = [k for k in out if k not in ("census", "scan")]
    assert labels == _reference_run_labels() and len(labels) == 11
    assert len(out["census"]) == 2 and out["scan"]["identical"]
    text = capsys.readouterr().out
    assert "trajectories bit-identical: True" in text
    for label in labels:
        assert f"\n{label:28s} loss=" in text


# ---------------------------------------------------- paper_mlp_repro

@functools.lru_cache(maxsize=None)
def _j_curve(n_train: int, seed: int = 0):
    """The reference script's ``train(n_train)`` in float32: its splits
    and init, and its val-accuracy curve."""
    j_splits = j_paper_splits(jax.random.PRNGKey(seed), n_train)
    j_p0 = jmlp.init(jax.random.PRNGKey(seed + 1), j_mlp_config())
    train_d = j_splits[0]

    @jax.jit
    def step(p):
        g = jax.grad(jmlp.loss_fn)(p, train_d)
        return jax.tree.map(lambda p, g: p - 1.0 * g, p, g)
    p = step(j_p0)
    accs = []
    for _ in range(paper_mlp_repro.EPOCHS):
        p = step(p)
        accs.append(float(jmlp.accuracy(p, j_splits[1]["x"],
                                        j_splits[1]["y"])))
    test_acc = float(jmlp.accuracy(p, j_splits[2]["x"], j_splits[2]["y"]))
    return j_splits, j_p0, accs, test_acc


@pytest.mark.parametrize("n_train", [500, 2000])
def test_paper_train_matches_reference(n_train):
    """``train(n)`` on the reference's splits and init: the val-accuracy
    curve within 1e-3 of the reference's at every epoch, the test
    accuracy too, and ``epochs_to`` alike."""
    j_splits, j_p0, ref, ref_test = _j_curve(n_train)
    data = tuple({"x": torch.tensor(np.asarray(d["x"])),
                  "y": torch.tensor(np.asarray(d["y"]).astype(np.int64))}
                 for d in j_splits)
    accs, t_epoch, test_acc = paper_mlp_repro.train(
        n_train, data=data, params=params_from_numpy(_np(j_p0)),
        device="cpu")
    assert len(accs) == paper_mlp_repro.EPOCHS and t_epoch > 0
    np.testing.assert_allclose(accs, ref, rtol=0, atol=1e-3)
    assert abs(test_acc - ref_test) <= 1e-3
    assert paper_mlp_repro.epochs_to(accs) == paper_mlp_repro.epochs_to(ref)


# ---------------------------------------------------- serve_quantized

@functools.lru_cache(maxsize=None)
def _j_serve():
    """The reference script's model, params, prompt and jitted step."""
    cfg = j_smoke(serve_quantized.ARCH)
    model = j_get_model(cfg)
    params = model.init(KEY0)
    prompt = jax.random.randint(jax.random.PRNGKey(1),
                                (1, serve_quantized.PROMPT_LEN), 0,
                                cfg.vocab_size)
    return model, params, prompt, jax.jit(j_serve_step(model))


# the script's eager call, jitted: the same bits, a quarter of the time
_j_compress = jax.jit(j_compress, static_argnums=1)


def _j_decode(p, gen: int):
    """The reference script's ``decode(p)``, with the gap between the two
    largest logits each token was chosen from."""
    model, _, prompt, serve = _j_serve()
    cache = model.init_cache(1, prompt.shape[1] + gen)
    pos = 0
    for i in range(prompt.shape[1]):
        logits, cache = serve(p, cache, prompt[:, i:i + 1], jnp.int32(pos))
        pos += 1
    toks, gaps = [], []
    for i in range(gen):
        if i:
            logits, cache = serve(p, cache, toks[-1], jnp.int32(pos))
            pos += 1
        top2 = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
        gaps.append(top2[1] - top2[0])
        toks.append(jnp.argmax(logits[:, -1:], -1).astype(jnp.int32))
    return np.asarray(jnp.concatenate(toks, axis=1)[0]), np.array(gaps)


def _tokens_agree(got, want, gaps, tie: float = 1e-4) -> bool:
    """Greedy tokens equal up to the first step whose deciding top-2
    logit gap is below ``tie`` (where an ulp may pick the other token
    and the two decodes part)."""
    close = np.flatnonzero(np.asarray(gaps) < tie)
    n = int(close[0]) + 1 if close.size else len(want)
    return np.array_equal(np.asarray(got)[:n], np.asarray(want)[:n])


@pytest.mark.parametrize("tier", ["hub", *serve_quantized.TIERS])
def test_serve_decode_matches_reference(tier):
    """``decode`` at each tier on the reference's params and prompt (the
    hub uncompressed, the others through ``compress_for_serving``), 12
    tokens: equal to the reference's up to its first near tie (top-2
    gap below 1e-4); ``payload_bits`` exactly."""
    gen = 12
    _, jp, jprompt, _ = _j_serve()
    plan, jplan = DEVICE_TIERS[tier], JC.DEVICE_TIERS[tier]
    want, gaps = _j_decode(jp if tier == "hub" else _j_compress(jp, jplan),
                           gen)
    model = get_model(get_smoke_config(serve_quantized.ARCH))
    tp = params_from_numpy(_np(jp))
    prompt = torch.tensor(np.asarray(jprompt), dtype=torch.int32)
    cp = tp if tier == "hub" else \
        serve_quantized.compress_for_serving(tp, plan)
    got, _ = serve_quantized.decode(
        model, serve_quantized.make_serve_step(model), cp, prompt, gen,
        "cpu")
    assert got.dtype == torch.int32 and got.shape == (gen,)
    assert _tokens_agree(got.numpy(), want, gaps), (got.tolist(), want, gaps)
    assert serve_quantized.payload_bits(tp, plan) == \
        JC.payload_bits(jp, jplan)


# -------------------------------------------------------- train_100m

def test_config_100m_matches_reference():
    """``config_100m()`` field for field the reference script's config;
    the params line's count, the port's init counted on fake tensors,
    equal to the reference's init's leaves: 80,753,152 (the reference's
    docstring says ~115M)."""
    cfg = train_100m.config_100m()
    want = JModelConfig(
        name="llama-100m", family="dense", num_layers=12, d_model=512,
        num_heads=8, num_kv_heads=4, d_ff=2048, vocab_size=32768,
        dtype="float32")
    assert cfg.__dict__ == want.__dict__
    shapes = jax.eval_shape(lambda: j_get_model(want).init(KEY0))
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    with fake_mode():
        params = get_model(cfg).init(0, device="cpu")
    assert sum(v.numel() for v in params.values()) == n == 80_753_152


NARROW = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              d_ff=128, vocab_size=256)


def test_train_100m_steps_match_reference(capsys):
    """Two steps of ``train`` on a narrowed ``config_100m()`` (2 layers,
    d_model 64, ffn 128, vocab 256; batch 8 x seq 16 over 4 tiers) from
    the reference's initial state, against the reference script's loop
    (its ``TokenStream`` iterated, AdamW(warmup_cosine(3e-4, 30, 2))):
    losses at rtol 1e-4, params at atol 1e-5; the script's lines."""
    cfg = train_100m.config_100m().replace(**NARROW)
    jcfg = JModelConfig(**cfg.__dict__)
    jmodel = j_get_model(jcfg)
    jo = jopt.adamw(jopt.warmup_cosine(3e-4, 30, 2))
    jstep = jax.jit(j_hetero_step(jmodel, jo, JC.default_tier_plans(4)))
    jp = jmodel.init(KEY0)
    js = dict(params=jp, opt=jo.init(jp), step=jnp.zeros((), jnp.int32))
    tp = params_from_numpy(_np(jp))
    to = topt.adamw(topt.warmup_cosine(3e-4, 30, 2))
    ts = dict(params=tp, opt=to.init(tp),
              step=torch.zeros((), dtype=torch.int32))
    jl = []
    for _, b in zip(range(2), JStream(cfg.vocab_size, 8, 16)):
        js, m = jstep(js, {"tokens": b["tokens"].reshape(4, 2, -1)})
        jl.append(float(m["loss"]))
    res = train_100m.train(cfg, steps=2, batch=8, seq=16, n_tiers=4,
                           device="cpu", state=ts)
    np.testing.assert_allclose(res["losses"], jl, rtol=1e-4)
    for name, a in params_from_numpy(_np(js["params"])).items():
        np.testing.assert_allclose(res["state"]["params"][name].numpy(),
                                   a.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"params: {res['params'] / 1e6:.1f}M, tiers: 4, " \
                     f"tokens/step: 128"
    assert [json.loads(line)["step"] for line in out[1:-1]] == [1, 2]
    assert out[-1] == "done"


# ----------------------------------------------------------- the CLIs

MODULES = {"quickstart": quickstart, "hetero_fl_sim": hetero_fl_sim,
           "paper_mlp_repro": paper_mlp_repro,
           "serve_quantized": serve_quantized, "train_100m": train_100m}


@pytest.mark.parametrize("name", list(MODULES))
def test_main_needs_a_gpu_unless_told_the_cpu(name, monkeypatch):
    """With no CUDA device, ``main([])`` raises before any work rather
    than drop to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MODULES[name].main([])


def test_quickstart_main_on_cpu(monkeypatch, capsys):
    """The script's lines at 10 rounds: the tier counts, rounds 5 and
    10, and the totals; the loss falls."""
    monkeypatch.setattr(quickstart, "ROUNDS", 10)
    res = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("tiers: {'hub': 1, 'high': 1, 'mid': 2, 'low': 1, "
                      "'embedded': 1}")
    assert [line.split()[1] for line in out[1:3]] == ["5", "10"]
    assert out[3].startswith("done — one global model from 6 ")
    assert len(res.records) == 10 and res.losses[-1] < res.losses[0]


def test_paper_main_on_cpu(monkeypatch, capsys):
    """One size at 5 epochs, both dtypes: the script's lines in order."""
    monkeypatch.setattr(paper_mlp_repro, "SIZES", (500,))
    monkeypatch.setattr(paper_mlp_repro, "EPOCHS", 5)
    res = paper_mlp_repro.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "== Fig 2/3: train-set size sweep (float32) =="
    assert out[1].startswith("n=  500  max_val_acc=")
    assert out[2] == "== Fig 4: data-type comparison (n=1000) =="
    assert out[3].startswith("float64:  max_val_acc=")
    assert out[4].startswith("float32:  max_val_acc=")
    assert set(res["dtypes"]) == {"float64", "float32"}
    assert all(len(r[0]) == 5 for r in res["sizes"].values())


def test_serve_main_on_cpu(monkeypatch, capsys):
    """At 6 generated tokens: the hub's line and the four tiers', each
    with its tokens, payloads shrinking with the tier."""
    monkeypatch.setattr(serve_quantized, "GEN", 6)
    res = serve_quantized.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("hub (fp32 full):  payload ")
    assert [line.split()[0] for line in out[2::2]] == \
        list(serve_quantized.TIERS)
    assert all(line.startswith("  tokens: ") for line in out[1::2])
    bits = [res[t]["bits"] for t in ("hub", *serve_quantized.TIERS)]
    assert bits == sorted(bits, reverse=True)
    assert all(res[t]["tokens"].shape == (6,) for t in res)


def test_train_main_on_cpu_checkpoints(monkeypatch, tmp_path):
    """``main`` on the narrowed config, 2 steps of 4 x 8 with a
    checkpoint every step: each checkpoint restores to the state it
    saved (the last one bitwise the final state), the losses finite."""
    cfg = train_100m.config_100m().replace(**NARROW)
    monkeypatch.setattr(train_100m, "config_100m", lambda: cfg)
    monkeypatch.setattr(train_100m, "CKPT_EVERY", 1)
    d = str(tmp_path / "ckpt")
    res = train_100m.main(["--steps", "2", "--batch", "4", "--seq", "8",
                           "--ckpt-dir", d, "--device", "cpu"])
    assert all(np.isfinite(res["losses"])) and len(res["losses"]) == 2
    ck = Checkpointer(d)
    assert ck.latest_step() == 2
    back, step = ck.restore(res["state"])
    assert step == 2 and int(back["step"]) == 2
    for k, v in res["state"]["params"].items():
        assert torch.equal(back["params"][k], v), k
