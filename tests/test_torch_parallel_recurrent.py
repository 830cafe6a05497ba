"""xLSTM, Zamba2 and Whisper trained over ``torch.distributed`` ranks
(the Mamba2 and xLSTM layers and the GELU MLP split over "model" as the
reference's ``param_spec_tree`` places them, the families' train step,
the train launcher under ``torchrun``), and the f32 sum of bf16 partials
over model ranks, on the CPU over gloo.

2 and 4 ranks run ``tests/_parallel_workers.py``'s ``run_recurrent``
once each, and the tests read their results against one process on the
same inputs: layers rtol 1e-5 / atol 1e-6 with their gradients, masks
bitwise, two AdamW steps' losses rtol 1e-4 and params atol 1e-5 on
(1, 2), (2, 1), (1, 4) and (2, 2). Last, the train launcher on 4 ranks
resumes the reference's own 4-device checkpoint of each family at
--model-parallel 2 and 4 and holds its losses and final checkpoint."""
import pytest
import torch

import _parallel_workers as W
from _parallel_workers import spawn

STEPS = {2: [(n, m) for n in W.RECURRENT for m in (2, 1)],
         4: [(n, m) for n in W.RECURRENT for m in (4, 2)]}
LAYERS = {2: ["mamba", "mlstm", "slstm", "gelu_mlp"],
          4: ["mamba", "mlstm", "slstm", "gelu_mlp", "mamba zamba-hd128",
              "mlstm xlstm-h2", "slstm xlstm-h2"]}

torch.set_num_threads(1)

_RANKS: dict = {}
_ONE: dict = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world -> the per-rank results of that many ranks (run once)."""
    def get(world: int) -> list[dict]:
        if world not in _RANKS:
            out = tmp_path_factory.mktemp(f"recurrent{world}")
            _RANKS[world] = spawn(world, out,
                                  {"recurrent": {"steps": STEPS[world]}})
        return _RANKS[world]
    return get


def _one_rank(name: str) -> dict:
    if name not in _ONE:
        _ONE[name] = W.one_rank_steps(name)
    return _ONE[name]


@pytest.mark.parametrize("direction", ["forward", "backward",
                                       "gather_to_ranks"])
@pytest.mark.parametrize("world", [2, 4])
def test_bf16_partials_sum_in_f32_and_round_once(ranks, world, direction):
    """The sum over "model" of bf16 partials is, bitwise, the f32 sum of
    every rank's partials rounded once to bf16, as the reference's
    sharded step all-reduces in f32: ``reduce_from_model``'s forward,
    and the backward of ``copy_to_model`` and of ``gather_to_ranks``
    (this rank's block of the summed gradient). At 4 ranks the old
    arithmetic (the bf16 all-reduce through gloo, each addition rounded)
    differs from it on these inputs, so this test tells the two apart;
    at 2 ranks the two agree (two bf16 values sum exactly in f32)."""
    for rank, res in enumerate(ranks(world)):
        r = res["bf16_sums"]
        want = torch.stack([p.float() for p in r["parts"]]).sum(0).to(
            torch.bfloat16)
        differs = int((r["old"] != want).sum())
        assert differs > 0 if world == 4 else differs == 0
        if direction == "gather_to_ranks":
            want = want.chunk(world)[rank]
        assert r[direction].dtype == torch.bfloat16
        assert torch.equal(r[direction], want)


@pytest.mark.parametrize("world,case", [(w, c) for w in (2, 4)
                                        for c in LAYERS[w]],
                         ids=lambda v: str(v))
def test_recurrent_layer_matches_one_rank(ranks, world, case):
    """Each split layer at mesh (1, world), its output and the gradients
    of a fixed random contraction of it (every leaf's made whole, the
    input's) against one rank, every rank the same bits.
    ``mamba_forward`` (zamba's smoke config: in_proj's columns, the
    conv's channels, the heads, gate_norm and out_proj's rows),
    ``mlstm_forward`` and ``slstm_forward`` (xLSTM's: up / qkv / gates /
    gates_x columns, r_gates' last dim, the heads by mnorm / gnorm and
    down's rows), ``gelu_mlp(split=True)`` (whisper's, biased); at 4
    ranks also the layouts whose d_in splits but whose heads do not (2
    heads over 4 ranks).

    The output is held at rtol 1e-5 / atol 1e-6. The ranks sum each
    row-split product's f32 partials and each gathered gradient in
    another order than one rank, and the gradients here reach 17-62, so
    their f32 rounding reaches a few 1e-6 on the one rank too: the
    one-rank f32 gradients lie up to 2e-5 from the same run in f64. So
    the gradients (the leaves' and the input's) are held at rtol 1e-5 /
    atol 1e-6 of the layer's largest gradient (as the attention d_model
    case of ``tests/test_torch_parallel.py``), and each lies within
    twice the one-rank f32 run's distance (+ 1e-6) of the f64 run: the
    ranks round no worse than one rank."""
    results = [res["layers"][case] for res in ranks(world)]
    (out, grads, gx), (out1, grads1, gx1), dims, (_, grads64, gx64) = \
        results[0]
    assert dims, "no leaf of the layer is split"
    torch.testing.assert_close(out, out1, rtol=1e-5, atol=1e-6)
    grads, grads1, grads64 = ({**g, "input": x} for g, x in (
        (grads, gx), (grads1, gx1), (grads64, gx64)))
    scale = max(g.abs().max().item() for g in grads1.values())
    for k in grads1:
        torch.testing.assert_close(grads[k], grads1[k], rtol=1e-5,
                                   atol=1e-6 * scale, msg=k)
        own = (grads1[k].double() - grads64[k]).abs().max().item()
        mine = (grads[k].double() - grads64[k]).abs().max().item()
        assert mine <= 2 * own + 1e-6, (k, mine, own)
    for (o, g, x), *_ in results[1:]:
        assert torch.equal(o, out) and torch.equal(x, gx)
        assert all(torch.equal(g[k], grads[k]) for k in g)


@pytest.mark.parametrize("what", [f"{n} {q}" for n in W.RECURRENT
                                  for q in ("fp8", "int8")])
@pytest.mark.parametrize("world", [2, 4])
def test_recurrent_masks_are_the_one_rank_blocks(ranks, world, what):
    """``compress_with_masks`` (pruned at 0.25, then fp8 e5m2 or int8 at
    the whole leaf's scale) of each family's smoke params on each rank's
    blocks: bitwise each rank's block of the one-rank result, masks
    included."""
    for res in ranks(world):
        local, whole = res["masks"][what]
        assert set(local) == set(whole)
        for k in whole:
            assert torch.equal(local[k], whole[k]), k


@pytest.mark.parametrize("world,name,mp", [
    (w, n, m) for w in (2, 4) for n in W.RECURRENT
    for m in sorted({2, w})], ids=lambda v: str(v))
def test_recurrent_place_gather_round_trip(ranks, world, name, mp):
    """Each family's train state at ``mp`` model shards of ``world`` ranks:
    every leaf placed is the block of the whole one and gathers back
    bitwise, and a rank holds exactly ``shard_bytes``; the recurrent
    leaves are split as the reference splits them."""
    key = name if mp == 2 else f"{name} {mp}"
    for res in ranks(world):
        r = res["round_trips"][key]
        assert r["blocks"] and r["gathered"]
        assert r["bytes"][0] == r["bytes"][1]
    specs = ranks(world)[0]["round_trips"][key]["specs"]
    if name == "xlstm-1.3b":
        assert specs["blocks.slstm.r_gates"] == (None,) * 4 + ("model",)
        assert specs["blocks.mlstm.qkv.w"] == (None, None, None, "model")
        assert specs["blocks.mlstm.down.w"] == (None, None, "model", None)
        assert specs["blocks.mlstm.conv_w"] == (None,) * 4
    if name == "zamba2-2.7b":
        assert specs["layers.mamba.in_proj.w"] == (None, None, "model")
        assert specs["layers.mamba.conv_w"] == (None, "model", None)
        assert specs["layers.mamba.a_log"] == (None, "model")
    if name == "whisper-tiny":
        assert specs["enc_layers.mlp.wi.b"] == (None, "model")
        assert specs["dec_layers.mlp.wo.b"] == (None, None)


@pytest.mark.parametrize("name,mp", STEPS[2], ids=lambda v: str(v))
def test_recurrent_adamw_steps_match_one_rank_2(ranks, name, mp):
    """Meshes (1, 2) and (2, 1): :func:`_parallel_workers.check_steps`."""
    W.check_steps(ranks(2), name, mp, _one_rank(name))


@pytest.mark.parametrize("name,mp", STEPS[4], ids=lambda v: str(v))
def test_recurrent_adamw_steps_match_one_rank_4(ranks, name, mp):
    """Meshes (1, 4) and (2, 2): :func:`_parallel_workers.check_steps`."""
    W.check_steps(ranks(4), name, mp, _one_rank(name))


@pytest.mark.parametrize("arch,mp", [(a, m) for a in W.RECURRENT
                                     for m in (2, 4)],
                         ids=lambda v: str(v))
def test_recurrent_launcher_matches_the_sharded_reference(tmp_path, arch,
                                                          mp):
    """:func:`_parallel_workers.launcher_vs_reference`: the reference's
    launcher on 4 host devices and the port's on 4 gloo ranks under
    torchrun, from the reference's step-1 checkpoint: losses 1e-4, the
    step-3 checkpoint 1e-5, the 4-rank file restoring bitwise in one
    process. At mp 4 whisper's and Zamba's attention take the head_dim
    fallback (2 kv heads over 4) and xLSTM runs one head a rank."""
    W.launcher_vs_reference(tmp_path, arch, mp)


@pytest.mark.parametrize("world,name", [(w, n) for w in (2, 4)
                                        for n in W.RECURRENT])
def test_census_equals_every_rank(ranks, world, name):
    """The dry run's census of each family's step on (1, world) (rank 0's
    trace on fake tensors, the scans by their multipliers) is, op by op,
    in count and bytes, exactly what every rank counted while it ran the
    step, its loops step by step."""
    want = W.dry_run_census(name, W.SHAPE, 1, world)
    assert want["count_by_op"]["all-reduce"] > 0
    for res in ranks(world):
        assert res["steps"][f"{name} {world}"]["census"] == want
