"""Tensor, expert and data parallel training of the decoder (dense, MoE,
VLM) over ``torch.distributed`` ranks, the loss of every family there,
and every family's prefill and decode on each rank's blocks of the
params and of the cache (``launch/mesh.py``, ``models/parallel.py``,
``models/sharding.place`` /
``gather``, the split layers, attention's head_dim and d_model
fallbacks, the MoE layer's experts and batch rows, the projector, the
pruning's reduced bisection, the train step's data rows, the
checkpointer, the train launcher under ``torchrun``), on the CPU over
gloo.

Pure tests first (the backend rule, rank coordinates, placement, the
identity outside a mesh). Then 2 and 4 ranks run every rank-side check
of ``tests/_parallel_workers.py`` once each, and the tests read their
results against one process on the same inputs: layers rtol 1e-5 / atol
1e-6 with their gradients, masks bitwise, two AdamW steps' losses rtol
1e-4 and params atol 1e-5, prefill and decode logits and caches 1e-5
(recurrent 5e-5), every rank's collectives the dry run's census; rank
0's traced steps on a census mesh run its share where the heads do not
split (the prefill's attention on its query rows, xLSTM's decode with
no gather of its state). Last,
the train launcher on 4 ranks resumes
the reference's own 4-device checkpoint and holds its losses and final
checkpoint (``tests/test_torch_parallel_bf16.py`` holds the bf16 step
on 2 and 4 ranks to the reference's own sharded one;
``tests/test_torch_parallel_recurrent.py`` trains xLSTM, Zamba and
Whisper over ranks)."""
import re

import numpy as np
import pytest
import torch

import _parallel_workers as W
from _parallel_workers import spawn as _spawn
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as train_mod
from repro_torch.checkpoint.checkpointer import named_leaves
from repro_torch.launch import specs
from repro_torch.launch.mesh import Mesh, backend_for, census_mesh
from repro_torch.models import get_model, parallel
from repro_torch.models.sharding import (P, blocks, cache_spec_tree, named,
                                         param_spec_tree, place)

CPU = torch.device("cpu")
STEPS = {2: [("llama3.2-3b", 2), ("llama3.2-3b", 1), ("qwen2.5-32b", 2),
             ("deepseek-7b", 2), ("granite-3-2b-v515", 2),
             ("deepseek-7b-v515", 2),
             ("granite-moe-1b-a400m", 2), ("granite-moe-1b-a400m", 1),
             ("qwen3-moe-30b-a3b", 2), ("qwen3-moe-30b-a3b", 1),
             ("granite-moe-cf1", 1), ("llava-next-34b", 2)],
         4: [("llama3.2-3b", 2), ("qwen-h8", 4),
             ("granite-moe-1b-a400m", 2), ("granite-moe-1b-a400m", 4),
             ("qwen3-moe-30b-a3b", 2), ("qwen3-moe-30b-a3b", 4),
             ("llava-next-34b", 2)]}
LAYERS = ("attn_forward", "attn_forward_flash", "swiglu", "embed_vocab",
          "embed_d_model", "unembed_vocab", "unembed_d_model",
          "cross_entropy_vocab", "vocab_chain")
OTHER_LAYERS = [(2, "moe_apply_rows_2x1"), (4, "moe_apply_rows_4x1"),
                (4, "moe_apply_rows_2x2")] + [
    (w, c) for w in (2, 4) for c in ("moe_apply", "attn_head_dim",
                                     "attn_head_dim_q", "attn_d_model",
                                     "projector")]

torch.set_num_threads(1)


_RANKS: dict = {}
_DIRS: dict = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world -> the per-rank results of that many ranks (run once)."""
    def get(world: int) -> list[dict]:
        if world not in _RANKS:
            out = _DIRS[world] = tmp_path_factory.mktemp(f"ranks{world}")
            extra = {"steps": STEPS[world]}
            if world == 4:
                extra["ckpt"] = {}
                for name in ("qwen-h8", "granite-moe-1b-a400m"):
                    src, dst = (out / f"one_rank {name}",
                                out / f"four_ranks {name}")
                    Checkpointer(str(src)).save(W.ckpt_state(name), 1)
                    extra["ckpt"][name] = [str(src), str(dst)]
            _RANKS[world] = _spawn(world, out, extra)
        return _RANKS[world]
    return get


_ONE: dict = {}


def _one_rank(name: str) -> dict:
    if name not in _ONE:
        _ONE[name] = W.one_rank_steps(name)
    return _ONE[name]


def _fake_mesh(mp: int = 2, world: int = 4) -> Mesh:
    """A mesh over ranks with no process group behind it: enough for
    every refusal, which comes before any collective."""
    ranks = np.arange(world).reshape(world // mp, mp)
    devices = np.empty(ranks.shape, dtype=object)
    devices.fill(CPU)
    return Mesh(devices, ("data", "model"), ranks=ranks)


# -------------------------------------------------------------- pure

@pytest.mark.parametrize("devices,backend", [
    (["cpu"] * 4, "gloo"),
    (["cuda"] * 2, "gloo"),                 # two ranks on one card
    (["cuda:0", "cuda:0"], "gloo"),
    (["cuda:0", "cuda:1", "cuda:2", "cuda:3"], "nccl"),
    (["cuda:0", "cpu"], "gloo"),
    (["cuda:1"], "nccl"),
])
def test_backend_for(devices, backend):
    assert backend_for(devices) == backend


@pytest.mark.parametrize("world,mp", [(2, 1), (2, 2), (4, 2), (4, 4), (8, 2)])
def test_rank_to_mesh_coordinates(world, mp):
    mesh = _fake_mesh(mp, world)
    assert dict(mesh.shape) == {"data": world // mp, "model": mp}
    assert mesh.is_distributed
    for r in range(world):
        assert mesh.coords(rank=r) == {"data": r // mp, "model": r % mp}
    one = Mesh(np.array([[CPU]], dtype=object), ("data", "model"))
    assert not one.is_distributed and one.coords() == {"data": 0, "model": 0}


def _moe_params():
    cfg = get_smoke_config("granite-moe-1b-a400m")
    return get_model(cfg).init(0, device=CPU)


@pytest.mark.parametrize("case,item", [
    ("moe", None), ("head_dim_fallback", None), ("mamba2", None),
    ("xlstm", None), pytest.param("fsdp", None, id="fsdp-20c")])
def test_place_refuses_outside_the_slice(case, item, monkeypatch):
    """Every layout of ``param_spec_tree`` is placed, each rank its blocks:
    the MoE leaves (experts on "model"), attention's head_dim fallback
    (llama's smoke Hkv 2 over 4 model shards), the recurrent leaves
    (Zamba's Mamba2 and xLSTM's mLSTM / sLSTM leaves, each family's
    whole state) and a data-axis entry (FSDP, ROADMAP item 20c), every
    leaf of them. No family is left to refuse (``tests/test_torch_fsdp.py``
    trains each one FSDP-placed)."""
    mesh = _fake_mesh(4 if case == "head_dim_fallback" else 2)
    if case == "moe":
        params = _moe_params()
        specs = param_spec_tree(params, 2)
        assert specs["layers.moe.we_g"] == P(None, "model", None, None)
    elif case == "head_dim_fallback":
        params = get_model(get_smoke_config("llama3.2-3b")).init(
            0, device=CPU)
        specs = param_spec_tree(params, 4)
        assert specs["layers.attn.wk.w"] == P(None, None, None, "model")
    elif case in ("mamba2", "xlstm"):
        arch = "zamba2-2.7b" if case == "mamba2" else "xlstm-1.3b"
        params = get_model(get_smoke_config(arch)).init(0, device=CPU)
        specs = param_spec_tree(params, 2)
        assert any(re.search(r"(mamba|mlstm|slstm)\.", k)
                   and "model" in specs[k] for k in params)
    else:
        params = {"layers.mlp.wi.w": torch.ones(2, 4, 8)}
        specs = param_spec_tree(params, 2, fsdp=(("data",), 2))
    sh = named(mesh, specs)
    if item is None:        # rank 1 keeps its blocks (no collective runs)
        monkeypatch.setattr(torch.distributed, "get_rank", lambda *a: 1)
        placed = place(params, sh)
        split = 0
        for k, x in params.items():
            assert torch.equal(placed[k], sh[k].block(x)), k
            split += placed[k].shape != x.shape
        assert split
        return
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        place(params, sh)


def test_place_takes_a_cache_tree(monkeypatch):
    """A decode cache is placed, cut and counted as params are: each leaf
    stacked over layers is this rank's block by ``cache_spec_tree``
    (batch rows over "data", the slots over "model"), ``slot_pos``
    whole; ``shard_bytes`` is the placed bytes; ``slot_range`` names the
    rank's slots."""
    from repro_torch.models.sharding import shard_bytes, slot_range
    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a: 3)
    mesh = _fake_mesh(2, 4)                 # rank 3 at (data 1, model 1)
    cfg = get_smoke_config("llama3.2-3b")
    cache = get_model(cfg).init_cache(4, 8, device=CPU)
    cache["layers"]["k"].normal_(generator=torch.Generator().manual_seed(0))
    sh = named(mesh, cache_spec_tree(cache, ("data",), 2))
    assert sh["layers"]["k"].spec == P(None, "data", "model", None, None)
    assert sh["layers"]["slot_pos"].spec == P(None, None)
    placed = place(cache, sh)
    assert torch.equal(placed["layers"]["k"],
                       cache["layers"]["k"][:, 2:4, 4:8])
    assert torch.equal(placed["layers"]["slot_pos"],
                       cache["layers"]["slot_pos"])
    assert shard_bytes(cache, sh) == sum(
        x.numel() * x.element_size() for x in placed["layers"].values())
    for k, x in placed["layers"].items():
        assert torch.equal(blocks(cache, sh)["layers"][k], x), k
    with parallel.using(mesh):
        assert slot_range(4, 8) == (4, 8) and slot_range(8, 8) == (0, 8)


_SERVE_ONE: dict = {}


def _one_rank_serve(name: str, t: int = W.SERVE_T, dp: int = 1,
                    b: int = W.SERVE_B) -> dict:
    """``W.serve_run`` of ``name`` in one process, num_groups ``dp``."""
    key = (name, t, dp, b)
    if key not in _SERVE_ONE:
        cfg = W.config(name)
        _SERVE_ONE[key] = W.serve_run(cfg, get_model(cfg).init(0, device=CPU),
                                      *W.serve_inputs(cfg, t, b), None, dp)
    return _SERVE_ONE[key]


def _cache_shardings(cache, dp: int, mp: int, rank: int,
                     b: int = W.SERVE_B) -> dict:
    """``cache_spec_tree``'s shardings of ``cache`` (``b`` rows) on the
    (dp, mp) mesh, answering for ``rank`` (a census mesh: no process
    group)."""
    mesh = W.abstract_mesh(dp, mp)
    bspec = specs._batch_spec(mesh, b)
    return named(census_mesh(mesh, rank), cache_spec_tree(cache, bspec, mp))


def check_serve(got: dict, one: dict, dp: int, mp: int, rank: int,
                bar: float, b: int = W.SERVE_B) -> None:
    """A rank's prefill and decode (``W.serve_run``) against one rank's:
    every call's logits (whole on every rank) within ``bar``; the cache
    after the prefill and after the last step within ``bar`` of the
    one-rank cache's blocks as ``cache_spec_tree`` places them, its
    ``slot_pos`` exact."""
    assert len(got["logits"]) == len(one["logits"]) == 1 + W.SERVE_STEPS
    for mine, want in zip(got["logits"], one["logits"]):
        torch.testing.assert_close(mine, want, rtol=0, atol=bar)
    for key in ("prefill_cache", "cache"):
        want = blocks(one[key], _cache_shardings(one[key], dp, mp, rank, b))
        for (name, x), (_, w) in zip(named_leaves(got[key]),
                                     named_leaves(want)):
            assert x.shape == w.shape, (key, name)
            if name.endswith("slot_pos"):
                assert torch.equal(x, w), (key, name)
            else:
                torch.testing.assert_close(x, w, rtol=0, atol=bar,
                                           msg=f"{key} {name}")


@pytest.mark.parametrize("arch", W.SERVE_ARCHS)
def test_other_families_refuse_a_mesh_of_ranks(ranks, arch):
    """(Named for what these families once did: refuse to serve over a
    mesh of ranks; now they all serve there.) Every family's loss runs
    on each rank's blocks at (1, 2) and (1, 4), the one-rank loss at
    rtol 1e-5 (the MoE and VLM decoders, xLSTM, Zamba and Whisper); and
    every family's prefill then three decode
    steps (``launch.specs``' setups' steps, num_groups the data ranks)
    run on each rank's blocks of the params and of the cache on (1, 2),
    (2, 1), (2, 2) and (1, 4): logits within 1e-5 of one rank's (the
    recurrent families 5e-5), each rank's cache within that of the
    one-rank cache's block placed by ``cache_spec_tree``, ``slot_pos``
    exact."""
    cfg = W.config(arch)
    bar = 5e-5 if arch in W.RECURRENT else 1e-5
    if arch in W.FAMILIES:
        one = get_model(cfg).loss_fn(get_model(cfg).init(0, device=CPU),
                                     W.family_batch(cfg)).item()
    for world in (2, 4):
        for mp in W.SERVE_MPS[world]:
            dp = world // mp
            for r, res in enumerate(ranks(world)):
                check_serve(res["serve"][f"{arch} {mp}"],
                            _one_rank_serve(arch, dp=dp), dp, mp, r, bar)
                if arch in W.FAMILIES and mp == world:
                    np.testing.assert_allclose(
                        res["families"][arch]["loss"], one, rtol=1e-5)


@pytest.mark.parametrize("case", list(W.SERVE_FALLBACKS))
def test_decode_attention_cache_fallbacks(ranks, case):
    """At 2 ranks, with a shape that does not divide, each fallback of
    ``cache_spec_tree``'s rule on (1, 2): a prompt of 9 puts the
    self-attention cache on its kv heads (llama's 2) or, with one kv
    head, on head_dim; one xLSTM head puts ``mC`` on dk, ``mn`` and the
    sLSTM states on their last dim (the mLSTM cell on this rank's block
    of dk, over a prompt of one chunk and of three); 15 encoder frames
    put Whisper's cross-KV on its kv heads or, with one, on head_dim; 3
    q heads put q on head_dim, so the prefill splits its query rows, 4
    a rank at a prompt of 8 (the cache on its slots), 5 and 4 at 9 (on
    head_dim). And on (2, 1) 3 rows that do not split over the data
    ranks: the batch whole on each (granite-moe, its MoE layer grouping
    it whole). Prefill and decode against one rank under
    ``check_serve``'s bars."""
    name, t, b, mp = W.SERVE_FALLBACKS[case]
    cfg = W.config(name)
    dp = 2 // mp
    one = _one_rank_serve(name, t, dp, b)
    sh = _cache_shardings(one["cache"], dp, mp, 0, b)
    split = {k: tuple(s.spec).index("model") - len(s.spec)
             for k, s in named_leaves(sh) if "model" in tuple(s.spec)}
    xlstm = {"mlstm/conv": -1, "mlstm/mC": -1, "mlstm/mn": -1,
             "slstm/sc": -1, "slstm/sn": -1, "slstm/sh": -1}
    want = {"kv heads": {"layers/k": -2, "layers/v": -2},
            "head_dim": {"layers/k": -1, "layers/v": -1},
            "xlstm last dim": xlstm, "xlstm chunks": xlstm,
            "q head_dim": {"layers/k": -3, "layers/v": -3},
            "q head_dim odd": {"layers/k": -1, "layers/v": -1},
            "cross kv heads": {"layers/enc_k": -2, "layers/enc_v": -2,
                               "layers/k": -3, "layers/v": -3},
            "cross head_dim": {"layers/enc_k": -1, "layers/enc_v": -1,
                               "layers/k": -3, "layers/v": -3},
            # "model" has one rank: the slots name it, and split nothing
            "rows whole": {"layers/k": -3, "layers/v": -3}}[case]
    assert split == want
    if case == "rows whole":
        assert all(s.spec[-4] is None for k, s in named_leaves(sh)
                   if k.endswith(("/k", "/v")))
    bar = 5e-5 if cfg.family in ("ssm", "audio") else 1e-5
    for r, res in enumerate(ranks(2)):
        check_serve(res["serve"][case], one, dp, mp, r, bar, b)


@pytest.mark.parametrize("case", list(W.SERVE_FALLBACKS))
def test_census_equals_every_fallback_rank(ranks, case):
    """The dry run's census of each fallback's prefill and decode step
    (rank 0's trace on an abstract mesh of its shape; xLSTM's three
    chunks counted by the scan's multiplier) is, op by op, in count and
    bytes, exactly what every rank counted in its prefill and in each of
    its decode steps."""
    name, t, b, mp = W.SERVE_FALLBACKS[case]
    prefill, decode = W.serve_shapes(t, b)
    want_p = W.dry_run_census(name, prefill, 2 // mp, mp)
    want_d = W.dry_run_census(name, decode, 2 // mp, mp)
    for res in ranks(2):
        got = res["serve"][case]["census"]
        assert got[0] == want_p
        assert got[1:] == [want_d] * W.SERVE_STEPS


def test_prefill_attention_rows_are_bitwise_one_rank(ranks):
    """``attn_prefill`` of 3 heads over 2 ranks (q, k and v on head_dim)
    at T = 2048: each rank attends with its 1024 query rows, which are
    one of the one-rank run's two chunks, so the output (``wo`` whole)
    and the whole k and v are bitwise the one-rank ones on every rank."""
    for res in ranks(2):
        mine, one = res["layers"]["attn_prefill_rows"]
        for a, w in zip(mine, one):
            assert a.shape == w.shape and torch.equal(a, w)


def _traced_rank(monkeypatch, name: str, shape, mod, attr: str, hook):
    """Rank 0's trace of ``name``'s step at ``shape`` (a shape of the
    caller's own, so traced anew) on a census mesh of (1, 2), with
    ``mod.attr`` wrapped: ``hook(fn, *a, **k)`` runs in its place.
    Returns the trace's counts."""
    fn = getattr(mod, attr)
    monkeypatch.setattr(mod, attr, lambda *a, **k: hook(fn, *a, **k))
    counts, _, _ = specs.rank_traced(W.config(name), shape,
                                     W.abstract_mesh(1, 2))
    return counts


def test_prefill_attention_runs_this_ranks_query_rows(monkeypatch):
    """Where q falls back from its heads (3 over 2 ranks), rank 0's
    traced prefill runs half of the one-rank trace's attention flops
    (the chunked attention's einsums, as the dry run counts them): its
    block of the query rows against the whole k and v, not every row."""
    from repro_torch.launch.analysis import StepCounter
    from repro_torch.models import layers as L
    flops = {"rank": 0, "one": 0}

    def hook(fn, *a, **k):
        counter = L._scan_counter()
        assert isinstance(counter, StepCounter)
        before = counter.flops
        out = fn(*a, **k)
        flops["rank" if parallel.multi_rank() else "one"] += \
            counter.flops - before
        return out
    _traced_rank(monkeypatch, "llama-h3",
                 W.ShapeConfig("rows", 64, 2, "prefill"), L,
                 "chunked_attention", hook)
    assert flops["one"] > 0 and 2 * flops["rank"] == flops["one"]


def test_xlstm_decode_gathers_no_mlstm_state(monkeypatch):
    """xLSTM's one head does not split over 2 ranks, so ``mC`` (B, H, hd,
    hd) and ``mn`` sit on their dk: rank 0's traced decode step updates
    and reads them on that block, and its census holds no all-gather of
    either (nor any as large as ``mC``'s block)."""
    from repro_torch.models import xlstm as TX
    cfg = W.config("xlstm-h1")
    b = 4
    _, hd, _ = TX.dims(cfg)
    gathered = []

    def hook(fn, x, *a, **k):
        out = fn(x, *a, **k)
        gathered.append((tuple(out.shape), out.numel() * out.element_size()))
        return out
    counts = _traced_rank(monkeypatch, "xlstm-h1",
                          W.ShapeConfig("dk", 8, b, "decode"), parallel,
                          "all_gather", hook)
    block = b * cfg.num_heads * hd * hd // 2 * 4
    assert counts["collectives"]["count_by_op"]["all-gather"] == len(gathered)
    assert gathered and max(n for _, n in gathered) < block
    whole = {(b, cfg.num_heads, hd, hd), (b, cfg.num_heads, hd)}
    assert not whole & {s for s, _ in gathered}


def test_outside_a_mesh_every_function_is_the_identity():
    """No mesh, or a mesh of one process: the collectives return their
    input itself, so the one-process step runs the ops it ran before."""
    x = torch.randn(3, 4)
    one = Mesh(np.array([[CPU, CPU]], dtype=object), ("data", "model"))
    for mesh in (None, one):
        with parallel.using(mesh):
            assert parallel.copy_to_model(x) is x
            assert parallel.reduce_from_model(x) is x
            assert parallel.gather_from_model(x, -1) is x
            assert parallel.split_to_model(x, -1) is x
            assert parallel.gather_to_ranks(x, -1) is x
            assert parallel.mean_over_data(x) is x
            assert parallel.all_reduce(x, "data") is x
            assert parallel.all_gather(x, "data", 0) is x
            assert parallel.size("model") == 1 and parallel.rank("model") == 0
    assert parallel.current() is None


# ------------------------------------------------------ over 2 and 4 ranks

@pytest.mark.parametrize("world", [2, 4])
def test_host_mesh_spans_the_world(ranks, world):
    for r, res in enumerate(ranks(world)):
        for mp, m in res["meshes"].items():
            assert m["shape"] == {"data": world // mp, "model": mp}
            assert m["ranks"] == np.arange(world).reshape(-1, mp).tolist()
            assert m["coords"] == {"data": r // mp, "model": r % mp}


@pytest.mark.parametrize("name", [*W.DENSE, "granite-3-2b-v515",
                                  "deepseek-7b-v515"])
@pytest.mark.parametrize("world", [2, 4])
def test_place_gather_round_trip(ranks, world, name):
    """At 2 model shards ((1, 2) on 2 ranks, (2, 2) on 4): every leaf of
    the train state placed is the block of the whole leaf and gathers
    back bitwise, and a rank holds exactly ``shard_bytes``."""
    for res in ranks(world):
        r = res["round_trips"][name]
        assert r["blocks"] and r["gathered"]
        assert r["bytes"][0] == r["bytes"][1]
    specs = ranks(world)[0]["round_trips"][name]["specs"]
    assert specs["layers.attn.wq.w"] == (None, None, "model", None)
    assert specs["layers.mlp.wo.w"] == (None, "model", None)
    vocab = ("model", None) if "v515" not in name else (None, "model")
    assert specs["embed"] == vocab
    if name.startswith("qwen"):
        assert specs["layers.attn.wq.b"] == (None, "model", None)
    if name.startswith("deepseek"):
        assert specs["lm_head.w"] == ((None, "model") if "v515" not in name
                                      else ("model", None))


@pytest.mark.parametrize("world,name,mp", [
    (w, n, m) for w in (2, 4) for n, m in W.OTHER_LAYOUTS[w]],
    ids=lambda v: str(v))
def test_place_gather_round_trip_other_layouts(ranks, world, name, mp):
    """The MoE (experts on "model"), VLM (the projector's columns) and
    attention-fallback states at ``mp`` model shards of ``world`` ranks:
    every leaf placed is the block of the whole one and gathers back
    bitwise, and a rank holds exactly ``shard_bytes``."""
    key = name if mp == 2 else f"{name} {mp}"
    for res in ranks(world):
        r = res["round_trips"][key]
        assert r["blocks"] and r["gathered"]
        assert r["bytes"][0] == r["bytes"][1]
    specs = ranks(world)[0]["round_trips"][key]["specs"]
    if "moe" in name:
        for k in ("we_g", "we_i", "we_o"):
            assert specs[f"layers.moe.{k}"] == (None, "model", None, None)
        assert specs["layers.moe.router.w"] == (None, None, None)
    if name == "llava-next-34b":
        assert specs["projector.w"] == (None, "model")
    if name == "llama3.2-3b" or ("moe" in name and mp == 4):   # Hkv 2
        assert specs["layers.attn.wq.w"] == (None, None, "model", None)
        assert specs["layers.attn.wk.w"] == (None, None, None, "model")
    if name.startswith("llama-d-model"):
        assert specs["layers.attn.wq.w"] == (None, "model", None, None)
        assert specs["layers.attn.wo.w"] == (None, None, "model")


@pytest.mark.parametrize("case", LAYERS)
@pytest.mark.parametrize("world", [2, 4])
def test_layer_matches_one_rank(ranks, world, case):
    """Each split layer at mesh (1, world), its output and the gradients
    of a fixed random contraction of it (the leaves' made whole, the
    input's) against one rank at rtol 1e-5 / atol 1e-6; every rank's
    result the same bits."""
    results = [res["layers"][case] for res in ranks(world)]
    (out, grads, gx), (out1, grads1, gx1) = results[0]
    torch.testing.assert_close(out, out1, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gx, gx1, rtol=1e-5, atol=1e-6)
    for k in grads1:
        torch.testing.assert_close(grads[k], grads1[k], rtol=1e-5,
                                   atol=1e-6, msg=k)
    for (o, g, x), _ in results[1:]:
        assert torch.equal(o, out) and torch.equal(x, gx)
        assert all(torch.equal(g[k], grads[k]) for k in g)


@pytest.mark.parametrize("what", ["masks_0.5", "masks_0.25", "masks_0.1",
                                  "compress_with_masks_fp8",
                                  "compress_with_masks_int8",
                                  "compress_with_masks_moe_fp8",
                                  "compress_with_masks_moe_int8",
                                  "compress_with_masks_attn_fallback_fp8",
                                  "compress_with_masks_head_dim_int8"])
@pytest.mark.parametrize("world", [2, 4])
def test_split_masks_are_the_one_rank_blocks(ranks, world, what):
    """``magnitude_masks(shardings=)`` on each rank's blocks (ties, leaves
    sharing a bisection and one past ``SMALL``) and
    ``compress_with_masks`` (pruned, then fp8 e5m2 or int8 at the whole
    leaf's scale) of a whole model: bitwise each rank's block of the
    one-rank result."""
    for res in ranks(world):
        local, whole = res["masks"][what]
        assert set(local) == set(whole)
        for k in whole:
            assert torch.equal(local[k], whole[k]), k


@pytest.mark.parametrize("world,case", OTHER_LAYERS, ids=lambda v: str(v))
def test_other_layout_matches_one_rank(ranks, world, case):
    """The MoE layer (experts over "model", choices dropped at capacity
    factor 1; output and aux loss, the router's gradient included), and
    over "data" ((world, 1), (2, 2): each rank its rows, one group
    straddling them, the step's mean of the gradients); attention with q
    on heads and k / v on head_dim (kv heads sliced per rank), with q and
    k / v on head_dim (every head on every rank), and on d_model with
    ``wo`` on its columns; the projected patches in front of the text:
    against one rank at rtol 1e-5 / atol 1e-6, output and gradients
    (every leaf's made whole, the input's), every rank the same bits.
    The d_model split sums each projection's f32 partials in another
    order, and that rounding reaches every gradient of the layer at the
    size of its largest (10-20 here; k's bias, whose exact gradient is 0
    under the softmax, is that noise alone), so its gradients are held at
    atol 1e-6 of the layer's largest gradient."""
    results = [res["layers"][case] for res in ranks(world)]
    (out, grads, gx), (out1, grads1, gx1) = results[0]
    torch.testing.assert_close(out, out1, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gx, gx1, rtol=1e-5, atol=1e-6)
    scale = (max(g.abs().max().item() for g in grads1.values())
             if case == "attn_d_model" else 1.0)
    for k in grads1:
        torch.testing.assert_close(grads[k], grads1[k], rtol=1e-5,
                                   atol=1e-6 * scale, msg=k)
    for (o, g, x), _ in results[1:]:
        assert torch.equal(o, out) and torch.equal(x, gx)
        assert all(torch.equal(g[k], grads[k]) for k in g)


@pytest.mark.parametrize("name,mp", STEPS[2], ids=lambda v: str(v))
def test_adamw_steps_match_one_rank_2(ranks, name, mp):
    _check_steps(ranks(2), name, mp)


@pytest.mark.parametrize("name,mp", STEPS[4], ids=lambda v: str(v))
def test_adamw_steps_match_one_rank_4(ranks, name, mp):
    _check_steps(ranks(4), name, mp)


def _check_steps(results, name, mp):
    W.check_steps(results, name, mp, _one_rank(name))


@pytest.mark.parametrize("world", [2, 4])
def test_launcher_mesh_spans_the_world_under_torchrun(ranks, world):
    """The twin of ``test_torch_lm_model.py::
    test_launcher_mesh_is_its_device_alone_on_a_multi_card_host``: with
    ``WORLD_SIZE > 1`` the launcher's mesh at --model-parallel 2 is the
    world's ranks, (world / 2, 2), and its loss is the one-process
    run's."""
    one = train_mod.train(get_smoke_config("llama3.2-3b"), steps=1, batch=8,
                          seq=8, device="cpu")
    for r, res in enumerate(ranks(world)):
        got = res["launcher"]
        assert got["shape"] == {"data": world // 2, "model": 2}
        assert got["ranks"] == np.arange(world).reshape(-1, 2).tolist()
        assert got["coords"] == {"data": r // 2, "model": r % 2}
        assert got["distinct"] == ["cpu"]
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-4)


def test_checkpoint_crosses_one_rank_and_four(ranks):
    """A one-rank checkpoint restores on 4 ranks as each rank's blocks,
    bitwise, and their save writes the one-rank file's leaves back,
    bitwise."""
    _crosses(ranks, "qwen-h8", "ckpt")


def test_moe_checkpoint_crosses_one_rank_and_four(ranks):
    """As above for granite-moe's smoke state at (1, 4): each rank one
    of its 4 experts, attention on the head_dim fallback."""
    _crosses(ranks, "granite-moe-1b-a400m", "ckpt granite-moe-1b-a400m")


def _crosses(ranks, name: str, key: str) -> None:
    assert all(res[key]["same"] and res[key]["step"] == 1
               for res in ranks(4))
    a = W.npz(_DIRS[4] / f"one_rank {name}" / "ckpt_00000001.npz")
    b = W.npz(_DIRS[4] / f"four_ranks {name}" / "ckpt_00000001.npz")
    assert set(a) == set(b)
    for k, (v, dt) in a.items():
        assert b[k][1] == dt and np.array_equal(b[k][0], v), k


# ---------------------------------------- against the sharded reference

@pytest.mark.parametrize("arch,mp", [
    ("llama3.2-3b", 2), ("granite-moe-1b-a400m", 2),
    ("granite-moe-1b-a400m", 4), ("llava-next-34b", 2)],
    ids=lambda v: str(v))
def test_launcher_matches_the_sharded_reference(tmp_path, arch, mp):
    """The reference's launcher on 4 host devices (a (4 / mp, mp) mesh at
    --model-parallel mp), 3 steps with a checkpoint each; the port's on 4
    gloo ranks under torchrun resumes from a copy of its step-1
    checkpoint to step 3: printed losses within 1e-4, every leaf of the
    step-3 checkpoint within 1e-5 (names and dtypes equal); that file,
    written by 4 ranks, restores bitwise in one process. granite-moe at
    mp 4 runs one expert a rank and attention on the head_dim fallback
    (Hkv 2 over 4); on (2, 2) its one 64-token group a tier straddles
    the data ranks."""
    W.launcher_vs_reference(tmp_path, arch, mp)


# (world, name, M) of the steps above run on a (1, M) mesh: there the dry
# run's FSDP layout splits nothing over its one data rank, so its step
# is the ranks' step
CENSUS = [(w, n, m) for w in (2, 4) for n, m in STEPS[w] if m == w]


@pytest.mark.parametrize("world,name,mp", CENSUS)
def test_census_equals_every_rank(ranks, world, name, mp):
    """The dry run's census of the step (rank 0's trace on fake tensors,
    no process group: ``launch.specs.rank_traced``) is, op by op, in
    count and bytes, exactly what every rank counted while it ran it
    (``parallel.counting``): the dense, MoE and VLM decoders over
    "model", the vocabulary's and attention's fallbacks included."""
    want = W.dry_run_census(name, W.SHAPE, world // mp, mp)
    assert want["count_by_op"]["all-reduce"] > 0
    for res in ranks(world):
        assert res["steps"][f"{name} {mp}"]["census"] == want


SERVE_CENSUS = [(w, mp) for w in (2, 4) for mp in W.SERVE_MPS[w]]


@pytest.mark.parametrize("arch", W.SERVE_ARCHS)
@pytest.mark.parametrize("world,mp", SERVE_CENSUS)
def test_census_equals_every_serving_rank(ranks, world, mp, arch):
    """The dry run's census of each family's prefill and decode step
    (rank 0's trace of ``launch.specs``' setups on an abstract (world /
    mp, mp) mesh) is, op by op, in count and bytes, exactly what every
    rank counted in its prefill and in each of its decode steps, on
    (1, 2), (2, 1), (2, 2) and (1, 4)."""
    prefill, decode = W.serve_shapes()
    want_p = W.dry_run_census(arch, prefill, world // mp, mp)
    want_d = W.dry_run_census(arch, decode, world // mp, mp)
    assert want_p["total_bytes"] > 0 and want_d["total_bytes"] > 0
    for res in ranks(world):
        got = res["serve"][f"{arch} {mp}"]["census"]
        assert got[0] == want_p
        assert got[1:] == [want_d] * W.SERVE_STEPS
