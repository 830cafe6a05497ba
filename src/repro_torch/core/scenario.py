"""Declarative scenario API: one frozen ``FLScenario`` assembled from
small policy objects — fleet x local training x upload compression x
participation x timing — with the reference's JSON wire format
(``to_dict``/``from_dict``), so one scenario file drives both packages.

:func:`build_server` assembles the runtime and :func:`simulate` runs it,
returning a :class:`RunResult` of typed :class:`RoundRecord` s. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; with no
GPU and no CPU request they raise.

Runtimes: the cohort runtime (``SyncWait``/``SyncDrop``), the per-client
loop (``runtime="client"``) and the asynchronous buffered runtime
(``AsyncBuffered``), each under an optional
:class:`~repro_torch.core.faults.FaultPolicy` (``faults=``). A fleet
with a :class:`~repro_torch.core.topology.FleetTopology` runs the cohort
runtime on edge grids, optionally placed over an
:class:`~repro_torch.core.topology.EdgeMesh` (``simulate(mesh=...)``).
``simulate`` makes runs durable (``checkpoint_every``/``checkpoint_dir``/
``resume_from``, :mod:`repro_torch.checkpoint.state`).
:func:`scenario_census` tabulates a scenario on the host alone.
"""
from __future__ import annotations

import dataclasses
import math
import types
from dataclasses import dataclass
from typing import Any, ClassVar

import torch

from repro_torch.core.compression import DEVICE_TIERS, active_param_count
from repro_torch.core.faults import FaultPolicy
from repro_torch.core.heterogeneity import PROFILES
from repro_torch.core.topology import (FleetTopology, cross_shard_bytes,
                                       shard_fleet)
from repro_torch.numerics import FORMATS

__all__ = [
    "FleetSpec", "LocalTraining", "UploadPolicy", "ParticipationPolicy",
    "TimingPolicy", "SyncWait", "SyncDrop", "AsyncBuffered", "FLScenario",
    "RoundRecord", "RunResult", "build_server", "simulate",
    "timing_from_dict", "resolve_device", "scenario_census",
]


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``. Never drops to the CPU on its
    own: without a GPU the caller must ask for ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return torch.device("cuda")


def _fields_dict(obj) -> dict:
    """Shallow dataclass -> dict with tuples downgraded to JSON lists."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = list(v) if isinstance(v, tuple) else v
    return out


# --------------------------------------------------------------- fleet

@dataclass(frozen=True)
class FleetSpec:
    """Who trains: one device tier per client (plan + Eq. (1) profile)
    plus the data partition that feeds them. The port draws its default
    data from a ``torch.Generator`` seeded with ``data_seed`` (other
    numbers than the reference's ``jax.random`` draws, by design).

    ``topology`` (optional) arranges the fleet hierarchically: a
    :class:`~repro_torch.core.topology.FleetTopology` partitioning the
    client ids into edge groups, each reporting one partial aggregate to
    the hub a round. Its JSON form ``{"edges": ...}`` is coerced."""
    tiers: tuple[str, ...]
    profiles: tuple[str, ...] | None = None
    n_samples: int = 0              # total dataset size; validated at build
    partition: str = "iid"          # iid | dirichlet
    alpha: float = 0.5              # dirichlet concentration
    data_seed: int = 0
    topology: FleetTopology | None = None

    def __post_init__(self):
        object.__setattr__(self, "tiers", tuple(self.tiers))
        if self.profiles is not None:
            object.__setattr__(self, "profiles", tuple(self.profiles))
        if isinstance(self.topology, dict):
            object.__setattr__(self, "topology",
                               FleetTopology.from_dict(self.topology))
        if self.topology is not None:
            self.topology.validate(len(self.tiers))
        if not self.tiers:
            raise ValueError("FleetSpec needs at least one client tier")
        for t in self.tiers:
            if t not in DEVICE_TIERS:
                raise ValueError(f"unknown tier {t!r}; known: {sorted(DEVICE_TIERS)}")
        for p in self.profiles or ():
            if p not in PROFILES:
                raise ValueError(f"unknown profile {p!r}; known: {sorted(PROFILES)}")
        if self.profiles is not None and len(self.profiles) != len(self.tiers):
            raise ValueError("profiles must match tiers length")
        if self.partition not in ("iid", "dirichlet"):
            raise ValueError(f"partition must be iid|dirichlet, got {self.partition!r}")

    @classmethod
    def cycling(cls, tiers, n_clients: int, *, profiles=None,
                samples_per_client: int = 16, edges: int | None = None,
                **kw) -> "FleetSpec":
        """``n_clients`` cycling over a short tier (and optionally
        profile) pattern, equal IID-able shards. ``edges=E`` attaches a
        contiguous E-group :class:`FleetTopology`."""
        t = tuple(tiers[i % len(tiers)] for i in range(n_clients))
        p = (None if profiles is None else
             tuple(profiles[i % len(profiles)] for i in range(n_clients)))
        topo = (None if edges is None
                else FleetTopology.contiguous(n_clients, edges))
        return cls(tiers=t, profiles=p,
                   n_samples=n_clients * samples_per_client,
                   topology=topo, **kw)

    @property
    def n_clients(self) -> int:
        return len(self.tiers)

    @property
    def client_profiles(self) -> tuple[str, ...]:
        return self.profiles if self.profiles is not None else self.tiers

    def shard_sizes(self) -> list[int]:
        """Per-client shard lengths under ``partition="iid"`` (the
        ``np.array_split`` convention); host arithmetic only."""
        n, c = self.n_samples, self.n_clients
        return [n // c + (1 if i < n % c else 0) for i in range(c)]

    def counts(self) -> dict[tuple[str, str], int]:
        """(tier, profile) -> client count, in first-appearance order."""
        out: dict[tuple[str, str], int] = {}
        for t, p in zip(self.tiers, self.client_profiles):
            out[(t, p)] = out.get((t, p), 0) + 1
        return out

    def build_clients(self, shards: list[dict] | None = None) -> list:
        """Materialize the fleet: partition the dataset (or take the
        given ``shards``, host tensors or numpy arrays) and attach plan +
        profile per client."""
        from repro_torch.core.federated import Client
        from repro_torch.data import (make_gaussian_dataset,
                                      partition_dirichlet, partition_iid)
        if shards is None:
            if self.n_samples < self.n_clients:
                raise ValueError(
                    f"n_samples={self.n_samples} cannot cover "
                    f"{self.n_clients} clients")
            gen = torch.Generator().manual_seed(self.data_seed)
            data = make_gaussian_dataset(gen, self.n_samples)
            if self.partition == "iid":
                shards = partition_iid(gen, data, self.n_clients)
            else:
                seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
                shards = partition_dirichlet(seed, data, self.n_clients,
                                             alpha=self.alpha)
        elif len(shards) != self.n_clients:
            raise ValueError(f"{len(shards)} shards for {self.n_clients} clients")
        shards = [{"x": torch.as_tensor(s["x"], dtype=torch.float32),
                   "y": torch.as_tensor(s["y"]).to(torch.int64)}
                  for s in shards]
        return [Client(i, DEVICE_TIERS[t], shards[i], profile_name=p)
                for i, (t, p) in enumerate(zip(self.tiers,
                                               self.client_profiles))]

    def to_dict(self) -> dict:
        d = _fields_dict(self)
        if self.topology is not None:
            d["topology"] = self.topology.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FleetSpec":
        d = dict(d)
        d["tiers"] = tuple(d["tiers"])
        if d.get("profiles") is not None:
            d["profiles"] = tuple(d["profiles"])
        return cls(**d)           # a topology dict is coerced in post_init


# ------------------------------------------------------------- policies

@dataclass(frozen=True)
class LocalTraining:
    """How a sampled client trains (paper §4.2), plus the sub-model axis:
    ``submodel="mask"`` emulates each tier's compression on full-shape
    arrays; ``"width"`` spends each tier's density budget as a dense
    width slice (``plan.as_width_sliced()``)."""
    mode: str = "fedsgd"            # fedsgd | fedavg
    local_steps: int = 5            # fedavg steps per round
    local_lr: float = 0.1           # fedavg on-device lr
    server_lr: float = 1.0          # fedavg server-side delta scale
    submodel: str = "mask"          # mask | width

    def __post_init__(self):
        if self.mode not in ("fedsgd", "fedavg"):
            raise ValueError(f"mode must be fedsgd|fedavg, got {self.mode!r}")
        if self.local_steps < 1:
            raise ValueError("local_steps must be >= 1")
        if self.submodel not in ("mask", "width"):
            raise ValueError(f"submodel must be mask|width, "
                             f"got {self.submodel!r}")

    def to_dict(self) -> dict:
        return _fields_dict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "LocalTraining":
        return cls(**d)


@dataclass(frozen=True)
class UploadPolicy:
    """Optional gradient/delta quantization with per-client error
    feedback (beyond-paper, off by default)."""
    quant: str | None = None        # a FORMATS name
    error_feedback: bool = False

    def __post_init__(self):
        if self.quant is not None and self.quant not in FORMATS:
            raise ValueError(f"unknown quant format {self.quant!r}; "
                             f"known: {sorted(FORMATS)}")
        if self.error_feedback and self.quant is None:
            raise ValueError("error_feedback without quant has nothing to feed back")

    def to_dict(self) -> dict:
        return _fields_dict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "UploadPolicy":
        return cls(**d)


@dataclass(frozen=True)
class ParticipationPolicy:
    """Per-round uniform sampling without replacement of
    ``max(1, round(fraction * n_clients))`` clients, drawn from
    ``np.random.default_rng([seed, step])`` as in the reference."""
    fraction: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {self.fraction}")

    def to_dict(self) -> dict:
        return _fields_dict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ParticipationPolicy":
        return cls(**d)


class TimingPolicy:
    """When the server aggregates: :class:`SyncWait`, :class:`SyncDrop`,
    or :class:`AsyncBuffered` (FedBuff-shaped buffered windows on the
    virtual clock)."""
    kind: ClassVar[str] = ""
    _KINDS: ClassVar[dict[str, type]] = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls.kind:
            TimingPolicy._KINDS[cls.kind] = cls

    def to_dict(self) -> dict:
        return {"kind": self.kind, **_fields_dict(self)}


def timing_from_dict(d: dict) -> TimingPolicy:
    d = dict(d)
    kind = d.pop("kind")
    try:
        cls = TimingPolicy._KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown timing kind {kind!r}; "
                         f"known: {sorted(TimingPolicy._KINDS)}") from None
    return cls(**d)


@dataclass(frozen=True)
class SyncWait(TimingPolicy):
    kind: ClassVar[str] = "sync_wait"


@dataclass(frozen=True)
class SyncDrop(TimingPolicy):
    deadline: float = 1.0           # seconds of analytic Eq. (1) time

    kind: ClassVar[str] = "sync_drop"

    def __post_init__(self):
        if self.deadline <= 0:
            raise ValueError("deadline must be > 0 seconds")


@dataclass(frozen=True)
class AsyncBuffered(TimingPolicy):
    buffer_size: int = 1            # uploads per aggregation (K of FedBuff)
    staleness_exp: float = 0.5      # a in (1+s)^-a; 0 turns the discount off
    time_jitter: float = 0.0        # lognormal sigma on per-dispatch times

    kind: ClassVar[str] = "async_buffered"

    def __post_init__(self):
        if self.buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")
        if self.staleness_exp < 0:
            raise ValueError("staleness_exp must be >= 0")
        if self.time_jitter < 0:
            raise ValueError("time_jitter must be >= 0")


# ------------------------------------------------------------- scenario

@dataclass(frozen=True)
class FLScenario:
    """One experiment: fleet x local x upload x participation x timing,
    plus the execution substrate (``"cohort"``: one step per plan;
    ``"client"``: the per-client loop, O(#clients) steps). ``faults``
    layers a :class:`FaultPolicy` over the run; ``None`` keeps every
    runtime on its clean path."""
    fleet: FleetSpec
    local: LocalTraining = LocalTraining()
    upload: UploadPolicy = UploadPolicy()
    participation: ParticipationPolicy = ParticipationPolicy()
    timing: TimingPolicy = SyncWait()
    runtime: str = "cohort"         # cohort | client
    faults: FaultPolicy | None = None

    def __post_init__(self):
        if self.runtime not in ("cohort", "client"):
            raise ValueError(f"runtime must be cohort|client, got {self.runtime!r}")
        if self.faults is not None:
            if (isinstance(self.timing, AsyncBuffered)
                    and self.faults.traces_availability):
                raise ValueError(
                    "availability traces (period/churn) are round-indexed — "
                    "the async virtual clock has no round index; model "
                    "async flakiness as dropout_rate + retry_backoff")
            if (self.faults.touches_uploads
                    and self.fleet.topology is not None):
                raise ValueError(
                    "upload corruption/defenses are not modeled for "
                    "hierarchical fleets (quarantine would happen at the "
                    "edge gateways); availability/churn/dropout faults "
                    "are fine")
        if self.runtime == "client":
            if not isinstance(self.timing, SyncWait):
                raise ValueError("the per-client runtime only supports "
                                 "SyncWait timing (no deadline/async path)")
            if self.participation.fraction < 1.0:
                raise ValueError("the per-client runtime has no participation "
                                 "sampling; use runtime='cohort'")
        if (isinstance(self.timing, AsyncBuffered)
                and self.participation.fraction < 1.0):
            raise ValueError("AsyncBuffered schedules every client on the "
                             "virtual clock; partial participation is a "
                             "sync-only knob")
        if self.fleet.topology is not None:
            if self.runtime == "client":
                raise ValueError("hierarchical topologies ride the cohort "
                                 "runtime's edge grids; the per-client "
                                 "loop has no edge axis")
            if isinstance(self.timing, AsyncBuffered):
                raise ValueError("AsyncBuffered aggregates per buffered "
                                 "window, not per edge; topology fleets "
                                 "are sync-only")

    def to_dict(self) -> dict:
        d = {"fleet": self.fleet.to_dict(),
             "local": self.local.to_dict(),
             "upload": self.upload.to_dict(),
             "participation": self.participation.to_dict(),
             "timing": self.timing.to_dict(),
             "runtime": self.runtime}
        if self.faults is not None:
            d["faults"] = self.faults.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FLScenario":
        faults = d.get("faults")
        return cls(fleet=FleetSpec.from_dict(d["fleet"]),
                   local=LocalTraining.from_dict(d["local"]),
                   upload=UploadPolicy.from_dict(d["upload"]),
                   participation=ParticipationPolicy.from_dict(
                       d["participation"]),
                   timing=timing_from_dict(d["timing"]),
                   runtime=d.get("runtime", "cohort"),
                   faults=(None if faults is None
                           else FaultPolicy.from_dict(faults)))


# ------------------------------------------------------- typed records

@dataclass(frozen=True)
class RoundRecord:
    """One sync round, typed (the reference's schema; fields the port's
    sync runtime does not produce stay ``None``). ``loss`` is ``None``
    for a zero-participant round."""
    step: int
    loss: float | None
    round_wall_time: float | None = None    # Eq. (1) round wall-clock
    t: float | None = None                  # async virtual clock
    total_upload_bytes: float = 0.0
    n_participants: int | None = None
    n_dropped: int | None = None            # by the SyncDrop deadline
    client_losses: tuple[float, ...] | None = None
    n_updates: int | None = None
    staleness_mean: float | None = None
    staleness_max: int | None = None
    n_versions_live: int | None = None
    n_dropouts: int | None = None
    n_corrupt: int | None = None

    @classmethod
    def from_history(cls, rec: dict) -> "RoundRecord":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in rec.items() if k in known})


@dataclass
class RunResult:
    """What :func:`simulate` returns: the scenario, its round records,
    the final model, the live runtime, and the aggregation backend the
    run actually used."""
    scenario: FLScenario
    records: tuple[RoundRecord, ...]
    params: dict
    opt_state: Any
    server: Any
    agg_backend: str = "sequential"

    @property
    def final(self) -> RoundRecord:
        return self.records[-1]

    @property
    def losses(self) -> tuple[float, ...]:
        return tuple(r.loss for r in self.records)

    @property
    def sim_time(self) -> float:
        """Simulated seconds: the async virtual clock, or the sum of
        per-round Eq. (1) wall times."""
        if isinstance(self.scenario.timing, AsyncBuffered):
            return float(self.final.t)
        return sum(r.round_wall_time for r in self.records)

    def summary(self) -> dict:
        return {"rounds": len(self.records), "loss": self.final.loss,
                "sim_time_s": self.sim_time,
                "total_upload_bytes": sum(r.total_upload_bytes
                                          for r in self.records)}


# ------------------------------------------------------------- factory

def build_server(scenario: FLScenario, model, optimizer, params: dict, *,
                 clients: list | None = None, shards: list | None = None,
                 device=None):
    """Assemble the runtime a scenario calls for on ``device``: the
    per-client loop, the async runtime or the cohort runtime.
    ``clients``/``shards`` override the fleet's data build."""
    from repro_torch.core.federated import (AsyncFLServer, CohortFLServer,
                                            FLServer)
    dev = resolve_device(device)
    if clients is None:
        clients = scenario.fleet.build_clients(shards)
    if scenario.local.submodel == "width":
        clients = [dataclasses.replace(c, plan=c.plan.as_width_sliced())
                   for c in clients]
    timing = scenario.timing
    common = dict(model=model, optimizer=optimizer,
                  params={k: v.to(dev) for k, v in params.items()},
                  mode=scenario.local.mode,
                  local_steps=scenario.local.local_steps,
                  local_lr=scenario.local.local_lr,
                  server_lr=scenario.local.server_lr,
                  upload_quant=scenario.upload.quant,
                  error_feedback=scenario.upload.error_feedback,
                  faults=scenario.faults)
    if scenario.runtime == "client":
        return FLServer(clients=clients, **common)
    if isinstance(timing, AsyncBuffered):
        return AsyncFLServer.from_clients(
            clients, dev, buffer_size=timing.buffer_size,
            staleness_exp=timing.staleness_exp,
            time_jitter=timing.time_jitter,
            seed=scenario.participation.seed, **common)
    kw = dict(common, sample_fraction=scenario.participation.fraction,
              seed=scenario.participation.seed,
              topology=scenario.fleet.topology)
    if isinstance(timing, SyncDrop):
        return CohortFLServer.from_clients(clients, dev, straggler="drop",
                                           deadline=timing.deadline, **kw)
    if isinstance(timing, SyncWait):
        return CohortFLServer.from_clients(clients, dev, straggler="wait",
                                           **kw)
    raise TypeError(f"unknown timing policy {type(timing).__name__}")


def _default_bundle(model, optimizer, params, init_seed: int, device):
    """Fill unspecified (model, optimizer, params) with the paper's MLP
    task: MLP loss + SGD(1.0) + seeded init (a ``torch.Generator``, so
    other numbers than the reference's init)."""
    from repro_torch import optim
    from repro_torch.configs.paper_mlp import config as mlp_config
    from repro_torch.models import mlp
    if model is None:
        model = types.SimpleNamespace(loss_fn=mlp.loss_fn)
    if optimizer is None:
        optimizer = optim.sgd(1.0)
    if params is None:
        params = mlp.init(torch.Generator().manual_seed(init_seed),
                          mlp_config(), device)
    return model, optimizer, params


ENGINES = ("eager", "scan", "scan_pallas")


def simulate(scenario: FLScenario, rounds: int, *, model=None,
             optimizer=None, params=None, clients: list | None = None,
             shards: list | None = None, init_seed: int = 0,
             engine: str = "eager", chunk_rounds: int | None = None,
             device=None, mesh=None, checkpoint_every: int | None = None,
             checkpoint_dir: str | None = None,
             resume_from: str | None = None) -> RunResult:
    """Build the scenario's runtime on ``device`` (default ``cuda``) and
    advance it ``rounds`` federated rounds (sync) or aggregation windows
    (``AsyncBuffered``). With no model/optimizer/params it runs the
    paper's MLP task.

    ``engine`` keeps the reference's names, so a call and its record read
    the same in both packages:

    - ``"eager"``: one ``round()`` / async ``step()`` per round, one host
      sync each.
    - ``"scan"``: :class:`~repro_torch.core.engine.ScanEngine` runs
      chunks of ``chunk_rounds`` rounds (default: all) with participation
      precomputed on the host and per-round metrics kept on the device,
      one host sync per chunk; sequential aggregation. ``AsyncBuffered``
      scenarios run :class:`~repro_torch.core.engine.WindowScanEngine`,
      bitwise the eager windows.
    - ``"scan_pallas"``: ``"scan"`` with fused aggregation. In the port
      that is one launch of the hand-written CUDA kernel
      ``csrc/fleet_aggregate.cu`` per round over every leaf, masked
      (``agg_backend == "pallas"``) and width-sliced
      (``"pallas_structured"``) fleets alike, bitwise the sequential
      chain. The async window engine has no tier axis to fuse,
      so ``AsyncBuffered`` runs it as ``"scan"``.

    The per-client runtime (``runtime="client"``) runs eager whatever
    ``engine`` says. ``result.agg_backend`` reports the backend used.
    Topology fleets aggregate per (plan, edge) partial and refuse
    ``"scan_pallas"``, as the reference does.

    ``mesh`` (topology fleets only): place the fleet's edge grids over an
    :class:`~repro_torch.core.topology.EdgeMesh` through
    :func:`~repro_torch.core.topology.shard_fleet` before running;
    placement only, the run stays bitwise the unsharded one. ``True``
    takes the default mesh over the run's device type (every CUDA
    device); a mesh is used as given.

    Durable runs: ``checkpoint_every=N`` saves the whole server state
    (params, optimizer state, EF buffers, the async version store and
    scheduler heap, the history) into ``checkpoint_dir`` every N rounds
    or windows of the whole trajectory (absolute boundaries, so a
    resumed run saves where the uninterrupted one does);
    ``resume_from=path`` restores the latest checkpoint there and runs
    the remaining ``rounds - restored_step``, and is also the save
    target when ``checkpoint_dir`` is not given. Every draw is stateless
    per round, so a killed and resumed run is bitwise the uninterrupted
    one. The files are the reference's format: either package resumes
    the other's.
    """
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    ckpt_dir = checkpoint_dir if checkpoint_dir is not None else resume_from
    if checkpoint_every is not None:
        if checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1 rounds")
        if ckpt_dir is None:
            raise ValueError("checkpoint_every needs checkpoint_dir "
                             "(or resume_from) to write into")
    dev = resolve_device(device)
    model, optimizer, params = _default_bundle(model, optimizer, params,
                                               init_seed, dev)
    srv = build_server(scenario, model, optimizer, params, clients=clients,
                       shards=shards, device=dev)
    if mesh is not None and mesh is not False:
        shard_fleet(srv, None if mesh is True else mesh)
    done = 0
    if resume_from is not None:
        from repro_torch.checkpoint.state import restore_run_state
        done = restore_run_state(srv, resume_from, scenario=scenario)
        if done > rounds:
            raise ValueError(
                f"checkpoint at step {done} is past rounds={rounds}")
    agg_backend = "sequential"
    is_async = isinstance(scenario.timing, AsyncBuffered)
    if engine == "eager" or scenario.runtime == "client":
        advance_one = srv.step if is_async else srv.round

        def advance(k):
            for _ in range(k):
                advance_one()
    else:
        from repro_torch.core.engine import ScanEngine, WindowScanEngine
        if is_async:
            eng = WindowScanEngine(srv, chunk_windows=chunk_rounds or 0)
        else:
            eng = ScanEngine(srv, chunk_rounds=chunk_rounds or 0,
                             agg="pallas" if engine == "scan_pallas"
                             else "sequential")
        agg_backend = eng.agg_backend
        advance = eng.run
    if checkpoint_every is None:
        if rounds > done:
            advance(rounds - done)
    else:
        from repro_torch.checkpoint.state import save_run_state
        while done < rounds:
            k = min(checkpoint_every - done % checkpoint_every,
                    rounds - done)
            advance(k)
            done += k
            if done % checkpoint_every == 0:
                save_run_state(srv, ckpt_dir, scenario=scenario)
    return RunResult(scenario=scenario,
                     records=tuple(RoundRecord.from_history(h)
                                   for h in srv.history),
                     params=srv.params, opt_state=srv.opt_state, server=srv,
                     agg_backend=agg_backend)


def scenario_census(scenario: FLScenario, params=None) -> dict:
    """A scenario's fleet, payload bytes and Eq. (1) time table, computed
    on the host from shapes alone (``params`` defaults to the paper
    MLP's, made on the CPU); the reference's table, key for key.

    Per (tier, profile) group: client count, per-round payload bytes and
    the Eq. (1) breakdown at the group's largest shard. Totals apply the
    timing policy: SyncDrop reports who the deadline drops,
    AsyncBuffered the buffer shape and dispatch-time spread instead of a
    round wall-clock. With partial participation
    ``total_upload_bytes_per_round`` is the expected value under uniform
    sampling. Shard sizes are exact for ``partition="iid"``; dirichlet
    sizes depend on the label draw, so the table assumes the even split
    and sets ``shard_sizes_exact=False``.
    """
    from repro_torch.configs.paper_mlp import config as mlp_config
    from repro_torch.core.heterogeneity import round_time
    from repro_torch.models import mlp
    if params is None:
        params = mlp.init(torch.Generator().manual_seed(0), mlp_config())
    spec = scenario.fleet
    local_steps = (scenario.local.local_steps
                   if scenario.local.mode == "fedavg" else 1)
    sizes = spec.shard_sizes()
    per_group: dict[tuple[str, str], dict] = {}
    per_client_T: list[float] = []
    per_client_bytes: list[float] = []
    per_client_active: list[float] = []
    client_plans: list = []
    active_memo: dict = {}
    total_bytes = 0.0
    for i, (tier, prof) in enumerate(zip(spec.tiers, spec.client_profiles)):
        plan = DEVICE_TIERS[tier]
        if scenario.local.submodel == "width":
            plan = plan.as_width_sliced()
        t = round_time(params, plan, PROFILES[prof], sizes[i], local_steps)
        per_client_T.append(t["T"])
        per_client_bytes.append(t["payload_bytes"])
        if plan not in active_memo:
            active_memo[plan] = float(active_param_count(params, plan))
        per_client_active.append(active_memo[plan])
        client_plans.append(plan)
        total_bytes += t["payload_bytes"]
        g = per_group.setdefault((tier, prof), {"count": 0, "n_shard": 0})
        g["count"] += 1
        if sizes[i] >= g["n_shard"]:
            g.update(n_shard=sizes[i],
                     **{k: t[k] for k in ("T_local", "T_upload", "T_global",
                                          "T_download", "T", "payload_bytes")})
    frac = scenario.participation.fraction
    n_sel = (spec.n_clients if frac >= 1.0
             else max(1, int(round(frac * spec.n_clients))))
    out = {"kind": "fl_scenario_census", "scenario": scenario.to_dict(),
           "n_clients": spec.n_clients, "n_samples": spec.n_samples,
           "shard_sizes_exact": spec.partition == "iid",
           "n_participants_per_round": n_sel,
           "total_upload_bytes_per_round": total_bytes * n_sel / spec.n_clients,
           "tiers": [{"tier": tier, "profile": prof, **g}
                     for (tier, prof), g in per_group.items()]}
    if spec.topology is not None:
        # per edge group: who reports there, the largest sub-model the
        # edge must hold, its Eq. (1) critical path and its device ->
        # edge uplink; and the edge -> hub traffic, which depends on the
        # plans and the edge count, never on the client count
        topo = spec.topology
        out["n_edges"] = topo.n_edges
        out["cross_shard_bytes_per_round"] = cross_shard_bytes(
            params, list(dict.fromkeys(client_plans)), topo.n_edges)
        out["edge_groups"] = [
            {"edge": e, "clients": len(ids),
             "active_params_max": max(per_client_active[c] for c in ids),
             "round_wall_time": max(per_client_T[c] for c in ids),
             "uplink_bytes": sum(per_client_bytes[c] for c in ids)}
            for e, ids in enumerate(topo.edges)]
    flt = scenario.faults
    if flt is not None:
        # steady-state availability = diurnal duty x P(no crash in the
        # rejoin window)
        duty = (math.ceil(flt.duty_cycle * flt.period) / flt.period
                if flt.period > 0 else 1.0)
        p_up = duty * (1.0 - flt.churn_rate) ** flt.rejoin_after
        out["faults"] = {
            "availability_expected": p_up,
            "dropout_rate": flt.dropout_rate,
            "corrupt_rate": flt.corrupt_rate,
            "expected_participants_per_round":
                n_sel * p_up * (1.0 - flt.dropout_rate),
            "finite_guard": flt.finite_guard,
            "clip_norm": flt.clip_norm,
            "max_retry_delay_s": sum(flt.retry_backoff * 2.0 ** a
                                     for a in range(flt.max_retries)),
        }
    timing = scenario.timing
    if isinstance(timing, AsyncBuffered):
        out["buffer_size"] = timing.buffer_size
        out["dispatch_T_min"] = min(per_client_T)
        out["dispatch_T_max"] = max(per_client_T)
    elif isinstance(timing, SyncDrop):
        dropped = sum(1 for T in per_client_T if T > timing.deadline)
        kept = [T for T in per_client_T if T <= timing.deadline]
        out["n_dropped_by_deadline"] = dropped
        out["round_wall_time"] = (timing.deadline if dropped
                                  else max(kept) if kept else 0.0)
    else:
        out["round_wall_time"] = max(per_client_T)
    return out
