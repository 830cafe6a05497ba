"""The reference's FSDP train layout over ``torch.distributed`` ranks on
the CPU over gloo: the train state of ``param_spec_tree(state, M,
fsdp=(("data",), D))`` (each leaf's largest dim left after the "model"
one split over "data" too), placed and gathered back, its masks, and
every family's train step on it (``models/parallel.gather_blocks``,
``layers.Blocks``, the step's data-axis sums).

2 ranks (the (2, 1) mesh here) and 4 ranks ((4, 1) and (2, 2),
``tests/test_torch_fsdp_4.py``) run ``tests/_parallel_workers.py``'s
``run_fsdp`` once each, and the tests read their results against one
process on the same inputs: placement bitwise and its bytes exactly
``shard_bytes``, the gather's forward and backward against the whole
tensor's, masks bitwise, three AdamW steps' losses rtol 1e-4 and params
atol 1e-5 (moments rtol 1e-4 / atol 1e-7) against one rank and against
the same mesh without FSDP, each gradient summed once, the run's
checkpoint restored bitwise in one process, and a rank's placed state
and batch rows against the dry run's argument bytes per device. Every
rank counts the collectives of its steps (``parallel.counting``); the
dry run's census of the same step (one rank's trace on fake tensors, no
process group) equals each rank's count exactly, and llama's gathers
and reduce-scatters equal a figure computed from its specs."""
import math

import numpy as np
import pytest
import torch

import _parallel_workers as W
from _parallel_workers import spawn
from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.core.steps import TrainState
from repro_torch.launch.dryrun import dry_run_step
from repro_torch.launch.mesh import Mesh
from repro_torch.models import get_model, parallel
from repro_torch.models import layers as L
from repro_torch.models.sharding import (NamedSharding, P, data_splits,
                                         named, param_spec_tree)

WORLD = 2
CPU = torch.device("cpu")

torch.set_num_threads(1)

_RANKS: dict = {}
_ONE: dict = {}


def ranks_of(world: int, tmp_path_factory) -> tuple[list, object]:
    """(the per-rank results of ``world`` ranks' ``run_fsdp``, its output
    directory), run once a process."""
    if world not in _RANKS:
        out = tmp_path_factory.mktemp(f"fsdp{world}")
        (out / "ckpt").mkdir()
        _RANKS[world] = spawn(world, out,
                              {"fsdp": {"ckpt": str(out / "ckpt")}},
                              W.FSDP_RANK_TIMEOUT), out
    return _RANKS[world]


def one_rank(name: str) -> dict:
    if name not in _ONE:
        _ONE[name] = W.fsdp_one_rank(name)
    return _ONE[name]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return ranks_of(WORLD, tmp_path_factory)[0]


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return ranks_of(WORLD, tmp_path_factory)[1]


def _fake_mesh(dp: int, mp: int) -> Mesh:
    """A mesh over ranks with no process group behind it."""
    devices = np.empty((dp, mp), dtype=object)
    devices.fill(CPU)
    return Mesh(devices, ("data", "model"),
                ranks=np.arange(dp * mp).reshape(dp, mp))


# ------------------------------------------------------------------- pure

@pytest.mark.parametrize("dp,mp", [(2, 1), (4, 1), (2, 2), (1, 2)])
def test_data_splits_name_the_fsdp_leaves(dp, mp):
    """``sharding.data_splits`` names each params leaf whose spec has a
    data entry, with that dim; none on a data axis of one rank, none on a
    mesh of one process, none without ``fsdp``."""
    params = get_model(W.config("llama3.2-3b")).init(0, device=CPU)
    specs = param_spec_tree(params, mp, fsdp=(("data",), dp))
    got = data_splits(named(_fake_mesh(dp, mp), specs))
    want = {k: (s.index("data"), ("data",)) for k, s in specs.items()
            if "data" in s}
    assert got == (want if dp > 1 else {})
    if dp > 1:
        assert "embed" in got and "final_norm" not in got
    one = Mesh(np.array([[CPU]], dtype=object), ("data", "model"))
    assert data_splits(named(one, param_spec_tree(
        params, 1, fsdp=(("data",), 1)))) == {}
    assert data_splits(named(_fake_mesh(dp, mp),
                             param_spec_tree(params, mp))) == {}


def test_blocks_carry_the_splits_through_the_views():
    """Outside a mesh of ranks a :class:`layers.Blocks` gathers nothing:
    each read is the block itself, and ``subtree``, ``nest`` and
    ``unstack`` give the views ``layers`` gives a dict, the split dims
    carried along (the stacked axis's own split gathered whole)."""
    gen = torch.Generator().manual_seed(0)
    leaves = {"embed": torch.randn((6, 4), generator=gen),
              "layers.attn.wq.w": torch.randn((3, 4, 2), generator=gen),
              "layers.ln1": torch.randn((3, 4), generator=gen),
              "layers.mlp.wi.b": torch.randn((3, 8), generator=gen)}
    split = {"embed": (1, ("data",)), "layers.attn.wq.w": (1, ("data",)),
             "layers.mlp.wi.b": (0, ("data",))}
    b = L.Blocks(leaves, split)
    assert set(b) == set(leaves) and len(b) == 4 and "embed" in b
    assert all(b[k] is v for k, v in leaves.items())
    assert b.get("missing") is None
    per = [L.nest(lp) for lp in L.unstack(L.subtree(b, "layers."))]
    plain = [L.nest(lp) for lp in L.unstack(L.subtree(leaves, "layers."))]
    assert len(per) == len(plain) == 3
    for got, want in zip(per, plain):
        assert set(got) == set(want)
        assert torch.equal(got["attn"]["wq.w"], want["attn"]["wq.w"])
        assert torch.equal(got["mlp"]["wi.b"], want["mlp"]["wi.b"])
        assert torch.equal(got["ln1"], want["ln1"])
        assert got["attn"].split == {"wq.w": (0, ("data",))}
        assert got["mlp"].split == {}          # gathered whole at unstack
        assert "ln1" not in got.split


def test_gather_blocks_is_the_identity_off_a_mesh():
    """No mesh, or a mesh of one process: ``gather_blocks`` returns its
    input itself and ``regathering`` changes no saved tensor."""
    x = torch.randn((4, 3))
    assert parallel.gather_blocks(x, 0, ("data",)) is x
    one = Mesh(np.array([[CPU]], dtype=object), ("data", "model"))
    with parallel.using(one):
        assert parallel.gather_blocks(x, 1, ("data",)) is x
    w = torch.randn((3, 2), requires_grad=True)
    with parallel.regathering():
        y = (x @ w).sum()
    y.backward()
    assert torch.equal(w.grad, x.sum(0)[:, None].expand(3, 2))


# ------------------------------------------------------------- on ranks

def check_round_trip(ranks, name: str, mp: int) -> None:
    for res in ranks:
        got = res["round_trips"][f"{name} {mp}"]
        assert got["blocks"] and got["gathered"]
        assert got["bytes"][0] == got["bytes"][1]
        assert got["data_split"] > 0


def check_gather(ranks, world: int, key: str) -> None:
    for rank, res in enumerate(ranks):
        got = res["gathers"][key]
        x, dim = got["x"], got["dim"]
        assert torch.equal(got["whole"], x)
        gs = torch.stack([g.to(torch.float32) for g in got["gs"]])
        want = gs.sum(0).to(x.dtype).chunk(world, dim)[rank]
        if world == 2:          # one addition, rounded once, as gloo's
            assert torch.equal(got["grad"], want), key
            continue
        # the f32 sum in another order: two orders of world - 1 additions
        # differ by at most 2 (world - 1) roundoffs of the sum of |g|; a
        # bf16 result then by one quantum of its own more
        slack = 2 * (world - 1) * 2.0 ** -24 * gs.abs().sum(0).chunk(
            world, dim)[rank]
        if x.dtype == torch.bfloat16:
            slack = slack + 2.0 ** -7 * want.to(torch.float32).abs()
        err = (got["grad"].to(torch.float32) - want.to(torch.float32)).abs()
        assert bool((err <= slack).all()), (key, err.max().item())


def check_regather(ranks) -> None:
    for res in ranks:
        off, on = res["gathers"]["regather False"], \
            res["gathers"]["regather True"]
        assert off["kept"] and not on["kept"]
        assert torch.equal(on["grad"], off["grad"])
        assert torch.equal(on["agrad"], off["agrad"])


def check_masks(ranks, name: str, mp: int) -> None:
    for res in ranks:
        got = res["masks"][f"{name} {mp}"]
        assert got["bitwise"] and got["masks"] > 0


def _close(got: dict, want: dict, what: str) -> None:
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    for k, v in want["params"].items():
        torch.testing.assert_close(got["params"][k], v, rtol=0, atol=1e-5,
                                   msg=f"{what} {k}")
        for mom in ("m", "v"):
            torch.testing.assert_close(got[mom][k], want[mom][k], rtol=1e-4,
                                       atol=1e-7, msg=f"{what} {mom} {k}")


def check_steps(ranks, name: str, mp: int) -> None:
    """Three AdamW steps FSDP-placed against one rank and against the same
    mesh without FSDP; every rank the same losses and gathered state."""
    fsdp = ranks[0]["steps"][f"{name} {mp} True"]
    plain = ranks[0]["steps"][f"{name} {mp} False"]
    assert fsdp["data_split"] > 0 and plain["data_split"] == 0
    _close(fsdp, one_rank(name), "one rank")
    _close(fsdp, plain, "no FSDP")
    for res in ranks[1:]:
        r = res["steps"][f"{name} {mp} True"]
        assert r["losses"] == fsdp["losses"]
        assert all(torch.equal(r["params"][k], fsdp["params"][k])
                   for k in fsdp["params"])


def check_once(ranks, name: str, mp: int, world: int) -> None:
    """AdamW's first moment is linear in the summed gradients: a leaf
    whose gradient were summed over "data" twice (the gather's
    reduce-scatter, then the step's all-reduce) would read dp times one
    rank's, one summed never 1 / dp of it. Held for the leaves split
    over "data" and for the others (the norms) apart."""
    fsdp = ranks[0]["steps"][f"{name} {mp} True"]
    one = one_rank(name)
    cfg = W.config(name)
    mesh = _fake_mesh(world // mp, mp)
    state = TrainState.create(get_model(cfg), W.adamw(), 0, device=CPU)
    split = data_splits(W.fsdp_specs(state, mesh)["params"])
    groups = {True: [], False: []}
    for k, m1 in one["m"].items():
        big = m1.abs() > 1e-3 * m1.abs().max()
        if big.any():
            ratio = (fsdp["m"][k][big] / m1[big]).median().item()
            groups[k in split].append((k, ratio))
    assert groups[True] and groups[False]
    for k, ratio in groups[True] + groups[False]:
        assert abs(ratio - 1.0) < 1e-3, (k, ratio)


def check_checkpoint(ranks, out, name: str, mp: int) -> None:
    """The FSDP run's checkpoint (written by its ranks, whole leaves)
    restores in one process bitwise the run's gathered state."""
    fsdp = ranks[0]["steps"][f"{name} {mp} True"]
    template = TrainState.create(get_model(W.config(name)), W.adamw(), 0,
                                 device=CPU)
    state, step = Checkpointer(str(out / "ckpt" / f"{name} {mp}")).restore(
        template)
    assert step == W.FSDP_STEPS
    assert int(state["step"]) == W.FSDP_STEPS
    for k in fsdp["params"]:
        assert torch.equal(state["params"][k], fsdp["params"][k]), k
        assert torch.equal(state["opt"]["m"][k], fsdp["m"][k]), k
        assert torch.equal(state["opt"]["v"][k], fsdp["v"][k]), k


def check_arg_bytes(ranks, world: int, mp: int) -> None:
    """A rank's FSDP-placed state plus the batch rows it takes equal, byte
    for byte, the dry run's argument bytes per device of the same step on
    an abstract mesh of the same shape (``launch.specs.train_setup``:
    fake tensors, nothing placed)."""
    devices = np.empty((world // mp, mp), dtype=object)
    devices.fill(torch.device("meta"))
    mesh = Mesh(devices, ("data", "model"))
    rec = dry_run_step(W.config("llama3.2-3b"), W.FSDP_SHAPE, mesh)
    want = rec["memory"]["argument_size_in_bytes"]
    for res in ranks:
        got = res["arg_bytes"][mp]
        assert got["state"] + got["batch"] == want


def check_census(ranks, name: str, mp: int, world: int) -> None:
    """The dry run's census of the FSDP step (rank 0's trace on a census
    mesh of the same shape) is, op by op, in count and bytes, exactly
    what every rank counted while it ran the step."""
    want = W.dry_run_census(name, W.FSDP_SHAPE, world // mp, mp)
    assert want["count_by_op"]["all-gather"] > 0
    assert want["count_by_op"]["reduce-scatter"] > 0
    for res in ranks:
        assert res["steps"][f"{name} {mp} True"]["census"] == want


def check_census_bytes(ranks, world: int, mp: int) -> None:
    """llama's FSDP collectives from its specs: each of the 4 tiers
    gathers every data-split leaf's "model" block whole over "data" (in
    the compute dtype), once for a leaf outside the layer stacks (kept
    through the backward) and twice for a layer's (once again in the
    backward, under ``regathering``), and reduce-scatters its gradient
    once, to this rank's block. Every all-gather and reduce-scatter of
    the step is one of these."""
    cfg = W.config("llama3.2-3b")
    state = TrainState.create(get_model(cfg), W.adamw(), 0, device=CPU)
    sh = W.fsdp_specs(state, _fake_mesh(world // mp, mp))["params"]
    item = getattr(torch, cfg.dtype).itemsize
    gathered = scattered = 0
    for k, (dim, _) in data_splits(sh).items():
        blk = math.prod(sh[k].shard_shape(state["params"][k].shape)) * item
        stacked = k.startswith("layers.")
        assert not (stacked and dim == 0), k
        gathered += blk * (world // mp) * (2 if stacked else 1)
        scattered += blk
    for res in ranks:
        got = res["steps"][f"llama3.2-3b {mp} True"]["census"]["bytes_by_op"]
        assert got["all-gather"] == 4 * gathered
        assert got["reduce-scatter"] == 4 * scattered


@pytest.mark.parametrize("name", W.FSDP_FAMILIES)
def test_fsdp_state_places_and_gathers_back(ranks, name):
    """Each family's train state FSDP-placed on (2, 1): every leaf this
    rank's block, gathered back bitwise, its bytes exactly
    ``shard_bytes``."""
    check_round_trip(ranks, name, 1)


@pytest.mark.parametrize("key", [f"{dt} {d}" for dt in
                                 (torch.float32, torch.bfloat16)
                                 for d in range(3)])
def test_gather_blocks_forward_and_backward(ranks, key):
    """``gather_blocks`` along each dim over 2 data ranks is the whole
    tensor; its backward the block of the ranks' summed gradients."""
    check_gather(ranks, WORLD, key)


def test_regathering_keeps_no_whole_leaf(ranks):
    """Under ``regathering`` a product saves the gathered leaf as its
    recipe: the whole leaf is gone after the forward (without it,
    autograd keeps it) and the backward gathers it again, to the same
    gradients bitwise."""
    check_regather(ranks)


@pytest.mark.parametrize("name", W.FSDP_FAMILIES)
def test_fsdp_masks_are_one_rank_blocks(ranks, name):
    """Densities 0.5 and 0.25 and the int8 step over the FSDP blocks are
    bitwise the one-rank results' blocks on (2, 1)."""
    check_masks(ranks, name, 1)


@pytest.mark.parametrize("name", W.FSDP_FAMILIES)
def test_fsdp_steps_match_one_rank(ranks, name):
    """Three AdamW steps on (2, 1) FSDP-placed against one rank and
    against (2, 1) without FSDP."""
    check_steps(ranks, name, 1)


@pytest.mark.parametrize("name", W.FSDP_FAMILIES)
def test_fsdp_sums_each_gradient_once(ranks, name):
    check_once(ranks, name, 1, WORLD)


@pytest.mark.parametrize("name", W.FSDP_FAMILIES)
def test_fsdp_checkpoint_restores_in_one_process(ranks, out_dir, name):
    check_checkpoint(ranks, out_dir, name, 1)


def test_dry_run_bytes_equal_a_fsdp_rank(ranks):
    check_arg_bytes(ranks, WORLD, 1)


def test_data_split_specs(ranks):
    """The (2, 1) FSDP specs split llama's embedding on d_model over
    "data" (its vocabulary takes "model" of one rank)."""
    state = TrainState.create(get_model(W.config("llama3.2-3b")),
                              optim.adamw(1e-3), 0, device=CPU)
    sh = W.fsdp_specs(state, _fake_mesh(2, 1))
    assert sh["params"]["embed"].spec == P("model", "data")
    assert isinstance(sh["params"]["embed"], NamedSharding)
    assert ranks[0]["round_trips"]["llama3.2-3b 1"]["data_split"] == len(
        data_splits(sh["params"]))


@pytest.mark.parametrize("name", W.FSDP_FAMILIES)
def test_census_equals_every_fsdp_rank(ranks, name):
    check_census(ranks, name, 1, WORLD)


def test_fsdp_census_bytes_follow_the_specs(ranks):
    check_census_bytes(ranks, WORLD, 1)
