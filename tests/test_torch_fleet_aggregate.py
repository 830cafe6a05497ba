"""The grouped aggregation (``repro_torch.kernels.fleet_aggregate``) on
the CPU: its plain version against the reference's Pallas kernels
(interpret mode off the TPU) and the port's sequential chain, the FL
engine's fused backend bitwise its sequential one, the wrapper's
refusals, and its launch path — the argument block it fills and its
chunking — driven through a host emulation of the CUDA kernel that reads
the block as the kernel does. The kernel itself is held against the
plain version on the card in test_torch_kernels_cuda.py."""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grad_aggregate import grad_aggregate as j_grad_aggregate
from repro.kernels.structured_scatter.ops import structured_scatter as j_scatter
from repro_torch.core.aggregation import (f32, finalize, scatter_accumulate,
                                          zeros_like_acc)
from repro_torch.core.compression import DEVICE_TIERS, submodel_spec
from repro_torch.fl import (FleetSpec, FLScenario, LocalTraining,
                            ParticipationPolicy, UploadPolicy, simulate)
from repro_torch.kernels import build
from repro_torch.kernels.fleet_aggregate import fleet_aggregate
from repro_torch.kernels.fleet_aggregate import ops as fleet
from repro_torch.kernels.grad_aggregate import grad_aggregate
from repro_torch.kernels.structured_scatter import (
    structured_scatter, structured_scatter_batched)

torch.set_num_threads(1)

W = [1.0, 0.5, 2.0, 1.0]
N_PART = [3.0, 0.0, 5.0, 1.0]          # tier 1 has count 0
WN = [f32(w) for w in W]
WD = [f32(f32(w) * f32(n)) for w, n in zip(W, N_PART)]
TIERS = ("hub", "high", "mid", "low")


def _same_values(a: np.ndarray, b: np.ndarray) -> bool:
    """Bitwise up to the sign of zero (the reference's compiled kernel
    folds ``0 + x`` to ``x`` and keeps a -0.0 that the IEEE add turns
    into +0.0); every nonzero value has the same bits."""
    nz = (a != 0) | (b != 0)
    return (a.shape == b.shape and np.array_equal(a, b)
            and np.array_equal(a[nz].view(np.uint32), b[nz].view(np.uint32)))


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and
            np.array_equal(a.contiguous().numpy().view(np.uint32),
                           b.contiguous().numpy().view(np.uint32)))


# ------------------------------------------------ against the reference

MASKED_SHAPES = [(1001,), (7, 13), (5, 10), (3, 4, 9)]


@pytest.mark.parametrize("scalar", [False, True])
def test_group_matches_reference_grad_aggregate(scalar):
    """A group of masked leaves against the reference's grad_aggregate
    per leaf; atol 1e-6 as in test_torch_kernels.py: the reference sums
    wn*m*g over the tier axis in one reduction, the port folds tiers in
    cohort order."""
    rng = np.random.default_rng(0)
    leaves, ref = {}, {}
    for i, shape in enumerate(MASKED_SHAPES):
        g = rng.standard_normal((4,) + shape).astype(np.float32)
        m = (np.array([1.0, 0.0, 1.0, 1.0], np.float32) if scalar else
             (rng.random((4,) + shape) < 0.6).astype(np.float32))
        ref[i] = np.asarray(j_grad_aggregate(
            jnp.asarray(g), jnp.asarray(m), jnp.asarray(WN),
            w_den=jnp.asarray(WD)))
        mt = torch.from_numpy(m)
        leaves[i] = (shape, [(torch.from_numpy(g[t]), mt[t])
                             for t in range(4)])
    out = fleet_aggregate(leaves, WN, WD)
    for i in leaves:
        assert out[i].shape == MASKED_SHAPES[i]
        np.testing.assert_allclose(out[i].numpy(), ref[i], rtol=0, atol=1e-6)


# leaf shape -> per-tier local shapes (prefix slices, full-width tiers
# first) and which tiers carry scalar masks
SCATTER_CASES = {
    "1d": ((10,), [(10,), (10,), (5,), (3,)], [True, True, True, True]),
    "2d": ((10, 10), [(10, 10), (10, 10), (5, 5), (3, 3)],
           [False, False, False, False]),
    "2d_edge": ((5, 10), [(5, 10), (5, 10), (5, 5), (5, 3)],
                [False, True, False, True]),
    "3d": ((4, 3, 6), [(4, 3, 6), (4, 3, 6), (2, 3, 3), (1, 3, 2)],
           [False, False, True, False]),
    "quads": ((6, 16), [(6, 16), (6, 16), (3, 8), (2, 6)],
              [False, False, False, True]),
}


def _scatter_leaf(case, rng):
    shape, locals_, scalar = SCATTER_CASES[case]
    gs = [rng.standard_normal(s).astype(np.float32) for s in locals_]
    ms = [np.ones((), np.float32) if sc
          else (rng.random(s) < 0.7).astype(np.float32)
          for s, sc in zip(locals_, scalar)]
    return shape, gs, ms


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_group_matches_reference_structured_scatter(case):
    """Each case's leaf in one group with every other case's: bitwise
    (up to the sign of zero) the reference's structured_scatter."""
    rng = np.random.default_rng(1)
    leaves, ref = {}, {}
    for name in sorted(SCATTER_CASES):
        shape, gs, ms = _scatter_leaf(name, rng)
        ref[name] = np.asarray(j_scatter(
            [jnp.asarray(g) for g in gs], [jnp.asarray(m) for m in ms],
            jnp.asarray(WN), jnp.asarray(WD), out_shape=shape))
        leaves[name] = (shape, [(torch.from_numpy(g), torch.from_numpy(m))
                                for g, m in zip(gs, ms)])
    out = fleet_aggregate(leaves, WN, WD)
    assert _same_values(out[case].numpy(), ref[case])


# ------------------------------------------- against the port's chain

def _mixed_round(seed=0, n_copies=1):
    """A round of the paper MLP's leaves (and ``n_copies`` renamed copies
    of them) over the four bench tiers, the low two width-sliced: per
    tier the update at its local shape, full masks on matrix leaves and
    scalar masks on biases except one tier's full bias mask. Returns
    (params, per-tier (g, m, weight, count), specs)."""
    from repro_torch.configs.paper_mlp import config
    from repro_torch.models import mlp
    base = mlp.init(torch.Generator().manual_seed(seed), config(), "cpu")
    params = {f"{c}.{k}": v for c in range(n_copies) for k, v in base.items()}
    rng = np.random.default_rng(seed)
    specs = [None, None,
             submodel_spec(params, DEVICE_TIERS["mid"].as_width_sliced().width),
             submodel_spec(params, DEVICE_TIERS["low"].as_width_sliced().width)]
    tiers = []
    for t, spec in enumerate(specs):
        g, m = {}, {}
        for i, (k, p) in enumerate(params.items()):
            loc = tuple(p.shape) if spec is None else spec.local_shape(i)
            g[k] = torch.from_numpy(rng.standard_normal(loc).astype(np.float32))
            if p.dim() >= 2 or t == 3:
                m[k] = torch.from_numpy((rng.random(loc) < 0.6)
                                        .astype(np.float32))
            else:
                m[k] = torch.ones(())
        tiers.append((g, m, W[t], N_PART[t]))
    return params, tiers, specs


def _chain(params, tiers, specs):
    acc = zeros_like_acc(params, dense_den=True)
    for (g, m, w, n), spec in zip(tiers, specs):
        acc = scatter_accumulate(acc, g, m, spec, w, n)
    return finalize(acc)


def _group(params, tiers):
    return {k: (p.shape, [(g[k], m[k]) for g, m, _, _ in tiers])
            for k, p in params.items()}


def test_mixed_round_is_the_chain_bitwise():
    """Masked and width-sliced tiers, scalar and full masks, a tier of
    count 0 and 1-D leaves in one group: bitwise the sequential
    scatter_accumulate -> finalize chain."""
    params, tiers, specs = _mixed_round()
    out = fleet_aggregate(_group(params, tiers), WN, WD)
    want = _chain(params, tiers, specs)
    assert list(out) == list(params)
    for k in params:
        assert _bits_equal(out[k], want[k]), k


def _scenario(kind: str) -> FLScenario:
    if kind == "masked":
        return FLScenario(fleet=FleetSpec.cycling(TIERS, 16),
                          participation=ParticipationPolicy(0.5, seed=11))
    if kind == "width":
        return FLScenario(fleet=FleetSpec.cycling(TIERS + ("embedded",), 10),
                          local=LocalTraining(submodel="width"))
    return FLScenario(
        fleet=FleetSpec.cycling(("hub", "high", "mid", "mid", "low",
                                 "embedded"), 12),
        local=LocalTraining(mode="fedavg", local_steps=2, local_lr=0.5),
        upload=UploadPolicy(quant="fp8_e4m3", error_feedback=True))


@pytest.mark.parametrize("kind", ["masked", "width", "fedavg_fp8_ef"])
def test_engine_fused_is_sequential_bitwise(kind):
    """ScanEngine(agg="pallas") — one fleet_aggregate call a round —
    bitwise agg="sequential" on the CPU."""
    sc = _scenario(kind)
    seq = simulate(sc, 3, engine="scan", device="cpu")
    fused = simulate(sc, 3, engine="scan_pallas", device="cpu")
    assert fused.agg_backend == ("pallas_structured" if kind == "width"
                                 else "pallas")
    assert fused.losses == seq.losses
    for k in seq.params:
        assert _bits_equal(fused.params[k], seq.params[k]), k


# ------------------------------------------------------------ refusals

def _leaf(T=4, shape=(6, 8), local=(6, 8)):
    return {"w": (shape, [(torch.ones(local), torch.ones(local))
                          for _ in range(T)])}


def _refused(case):
    if case == "meta_device":
        z = torch.zeros((6, 8), device="meta")
        return {"w": ((6, 8), [(z, z)] * 4)}, ValueError
    if case == "mixed_devices":
        z = torch.zeros((6, 8), device="meta")
        return {"w": ((6, 8), [(torch.ones(6, 8), z)] * 4)}, ValueError
    if case == "f64_update":
        return {"w": ((6, 8), [(torch.ones(6, 8, dtype=torch.float64),
                                torch.ones(6, 8))] * 4)}, TypeError
    if case == "f16_mask":
        return {"w": ((6, 8), [(torch.ones(6, 8),
                                torch.ones(6, 8, dtype=torch.float16))] * 4)}, \
            TypeError
    if case == "non_contiguous_update":
        return {"w": ((6, 8), [(torch.ones(8, 6).t(), torch.ones(6, 8))] * 4)}, \
            ValueError
    if case == "non_contiguous_mask":
        return {"w": ((6, 8), [(torch.ones(6, 8), torch.ones(8, 6).t())] * 4)}, \
            ValueError
    if case == "nine_tiers":
        return _leaf(T=9), ValueError
    if case == "tiers_unlike_weights":
        return _leaf(T=3), ValueError
    if case == "larger_than_leaf":
        return _leaf(local=(7, 8)), ValueError
    if case == "mid_axis_sliced":
        return _leaf(shape=(4, 3, 6), local=(2, 2, 3)), ValueError
    if case == "rank_differs":
        return _leaf(shape=(6, 8), local=(48,)), ValueError
    if case == "mask_size":
        return {"w": ((6, 8), [(torch.ones(6, 8), torch.ones(6, 4))] * 4)}, \
            ValueError
    raise KeyError(case)


REFUSALS = ["meta_device", "mixed_devices", "f64_update", "f16_mask",
            "non_contiguous_update", "non_contiguous_mask", "nine_tiers",
            "tiers_unlike_weights", "larger_than_leaf", "mid_axis_sliced",
            "rank_differs", "mask_size"]


@pytest.mark.parametrize("case", REFUSALS)
def test_wrapper_refuses(case):
    """What the kernel does not take is refused on every device (so the
    CPU path refuses what the card would), and nothing falls back."""
    leaves, err = _refused(case)
    t = len(leaves["w"][1]) if case == "nine_tiers" else 4
    wn = [1.0] * t
    with pytest.raises(err):
        fleet_aggregate(leaves, wn, wn)


def test_cpu_path_never_builds(monkeypatch):
    """CPU tensors take the plain version: no library is built or
    loaded, and no launch is counted."""
    def no_build(*a, **k):
        raise AssertionError("the CPU path called build.load")
    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(fleet, "load", no_build)
    fleet._launcher.cache_clear()
    before = (fleet_aggregate.launches, grad_aggregate.launches,
              structured_scatter.launches)
    params, tiers, _ = _mixed_round()
    fleet_aggregate(_group(params, tiers), WN, WD)
    g = torch.ones(4, 10)
    grad_aggregate(g, g, W)
    structured_scatter([g[0], g[1, :5]], [g[0], torch.tensor(1.0)], [1.0, 1.0],
                       out_shape=(10,))
    simulate(_scenario("masked"), 1, engine="scan_pallas", device="cpu")
    assert (fleet_aggregate.launches, grad_aggregate.launches,
            structured_scatter.launches) == before


# ------------------------------------- the launch path, kernel emulated

def _host(ptr: int, n: int) -> np.ndarray:
    """n f32 values at a host address (a CPU tensor's data_ptr)."""
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))


class _EmulatedKernel:
    """Reads the argument block the wrapper passes, as the kernel does,
    and computes the kernel's arithmetic in numpy f32 (each op rounded,
    no FMA) into the slab. Records each launch's grid and leaf count."""

    def __init__(self):
        self.launches = []
        self.wave = 5              # a leaf of more quads takes a loop
        self.args = fleet.FleetArgs()
        self.addr = ctypes.addressof(self.args)
        self.ptrs = np.frombuffer(self.args, np.uint64, 2 * 16 * 8).reshape(
            2, fleet.MAX_LEAVES, fleet.MAX_TIERS)
        self.weights = None

    def fn(self, addr, grid, stream):
        a = fleet.FleetArgs.from_address(addr)
        T, n = a.n_tiers, a.n_leaves
        assert 1 <= T <= fleet.MAX_TIERS and 1 <= n <= fleet.MAX_LEAVES
        starts = list(a.block_start)[:n + 1]
        assert starts[0] == 0 and grid == starts[n]
        assert all(x <= y for x, y in zip(starts, starts[1:]))
        self.launches.append((grid, n))
        for k in range(n):
            R, C = a.R[k], a.C[k]
            assert (starts[k + 1] - starts[k]) == fleet.leaf_blocks(
                R, C, self.wave)
            assert a.out_off[k] % 4 == 0
            num = np.zeros((R, C), np.float32)
            den = np.zeros((R, C), np.float32)
            for t in range(T):
                r, c = a.rows[k][t], a.cols[k][t]
                assert r <= R and c <= C
                g = _host(a.g[k][t], r * c).reshape(r, c)
                m = (_host(a.m[k][t], 1)[0] if (a.scalar_bits[k] >> t) & 1
                     else _host(a.m[k][t], r * c).reshape(r, c))
                wn, wd = np.float32(a.wn[t]), np.float32(a.wd[t])
                num[:r, :c] = num[:r, :c] + m * (wn * g)
                den[:r, :c] = den[:r, :c] + m * wd
            out = _host(a.out + 4 * a.out_off[k], R * C)
            out[:] = (num / np.maximum(den, np.float32(a.eps))).reshape(-1)
        return 0


@pytest.fixture
def emulated(monkeypatch):
    """The CUDA launch path on CPU tensors, the kernel emulated."""
    kern = _EmulatedKernel()
    fleet._launcher.cache_clear()
    monkeypatch.setattr(fleet, "_launcher", lambda: kern)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: -1)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 0, raising=False)
    return kern


def _launch_path(leaves, wn, wd):
    geos, flat = fleet._plan(leaves.values(), len(wn))
    slab = torch.full((sum(geo.size for geo in geos),), float("nan"))
    fleet._launch(geos, flat, wn, wd, fleet.EPS, slab)
    out, off = {}, 0
    for k, geo in zip(leaves, geos):
        out[k] = slab.as_strided(geo.shape, geo.strides, off)
        off += geo.size
    return out


def test_launch_path_mixed_round_bitwise(emulated):
    """The argument block of a mixed round (masked and sliced tiers,
    scalar and full masks, count 0, 1-D leaves), read as the kernel reads
    it, gives the plain version's bits: one launch, every leaf."""
    params, tiers, _ = _mixed_round(seed=2)
    leaves = _group(params, tiers)
    before = fleet_aggregate.launches
    got = _launch_path(leaves, WN, WD)
    plain = fleet_aggregate(leaves, WN, WD)
    assert emulated.launches == [(sum(fleet.leaf_blocks(
        *fleet.view2d(tuple(p.shape)), emulated.wave)
        for p in params.values()), 12)]
    assert fleet_aggregate.launches == before + 1
    for k in params:
        assert _bits_equal(got[k], plain[k]), k


@pytest.mark.parametrize("copies,launches", [(1, 1), (3, 3), (4, 3)])
def test_launch_path_chunks_by_max_leaves(emulated, copies, launches):
    """More leaves than MAX_LEAVES take ceil(leaves / MAX_LEAVES)
    launches into one slab, each right."""
    params, tiers, _ = _mixed_round(seed=3, n_copies=copies)
    leaves = _group(params, tiers)
    got = _launch_path(leaves, WN, WD)
    plain = fleet_aggregate(leaves, WN, WD)
    n = len(params)
    assert [x[1] for x in emulated.launches] == (
        [fleet.MAX_LEAVES] * (n // fleet.MAX_LEAVES)
        + ([n % fleet.MAX_LEAVES] if n % fleet.MAX_LEAVES else []))
    assert len(emulated.launches) == launches
    for k in params:
        assert _bits_equal(got[k], plain[k]), k


def test_launch_path_public_wrappers_count_their_launches(emulated,
                                                          monkeypatch):
    """grad_aggregate and structured_scatter are groups of one leaf (or
    of L leaves) and count the launches they make."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda s: True))
    monkeypatch.setattr(torch.Tensor, "is_cpu", property(lambda s: False))
    rng = np.random.default_rng(4)
    g = torch.from_numpy(rng.standard_normal((4, 5, 10)).astype(np.float32))
    m = torch.from_numpy((rng.random((4, 5, 10)) < 0.5).astype(np.float32))
    b = (grad_aggregate.launches, structured_scatter.launches)
    out = grad_aggregate(g, m, W, w_den=WD)
    gs = [torch.from_numpy(rng.standard_normal((20,) + s).astype(np.float32))
          for s in [(10, 10), (10, 10), (5, 5), (3, 3)]]
    ms = [torch.ones(20)] * 4
    res = structured_scatter_batched(gs, ms, W, WD, out_shape=(10, 10))
    assert (grad_aggregate.launches, structured_scatter.launches) == \
        (b[0] + 1, b[1] + 2)                 # 20 leaves: two launches
    monkeypatch.undo()
    want = fleet_aggregate({"x": ((5, 10), [(g[t], m[t]) for t in range(4)])},
                           WN, WD)["x"]
    assert _bits_equal(out, want)
    for l in (0, 7, 19):
        want = fleet_aggregate({"x": ((10, 10), [(x[l], y[l]) for x, y
                                                 in zip(gs, ms)])},
                               WN, WD)["x"]
        assert _bits_equal(res[l], want)
