"""Fleet topology: hierarchical device -> edge -> hub aggregation.

IoT deployments do not upload every client's update to one server:
devices report to EDGE gateways, and each edge forwards ONE partial
aggregate to the hub, so edge -> hub traffic is O(params) per edge per
round whatever the number of devices behind a gateway. This module is
that hierarchy for the cohort runtime, with the reference's names:

- :class:`FleetTopology`: the static spec, a partition of client ids
  into ordered edge groups. Frozen, hashable, JSON round-tripping
  (``FleetSpec(topology=...)``).
- :class:`EdgeCohort` / :func:`build_edge_cohorts`: per plan, each
  edge's sub-cohort is one ROW of a padded ``(E, cap, n, ...)`` grid
  (padding rows have participation 0 forever and add exact zeros).
- Placement: :func:`make_edge_mesh` is a tuple of devices;
  :func:`shard_fleet` puts each contiguous block of edges (the grid
  data, the EF rows, each round's participation grid) on its device as
  :class:`EdgeBlocks` and keeps params and optimizer state on the hub
  device. Each block's edge step runs on its own device and the
  per-edge partials come back to the hub for the fixed-order combine.
- :func:`cross_shard_bytes`: the analytic edge -> hub traffic model of
  the census: per round each (plan, edge) forwards one update tree, one
  mask tree and a loss scalar, so the bytes depend on the plans and E,
  never on the client count.

Bit-identity: the hub combine is a sequential chain over plans in
first-appearance order and edges in index order, through the flat
runtime's ``scatter_accumulate``; and the edge step computes each edge
in shapes that do not depend on how the edges are blocked (per edge for
every product and inexact reduction, batched over a block only for the
compression's elementwise ops and exact reductions:
``federated.edge_step_fn``). So a sharded run is bitwise the unsharded
one. The edge step is not bitwise the flat cohort step, so a topology
fleet is its own numerical reference (the reference's vmapped edge step
is not bitwise its flat step either).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "FleetTopology", "EdgeCohort", "build_edge_cohorts", "scatter_part",
    "EdgeMesh", "EdgeBlocks", "make_edge_mesh", "edge_sharding",
    "replicated_sharding", "shard_fleet", "cross_shard_bytes",
]


@dataclass(frozen=True)
class FleetTopology:
    """A static partition of client ids into ordered edge groups.

    ``edges[e]`` is the tuple of client ids reporting to edge gateway
    ``e``; the hub is implicit. Ids must be unique across edges and every
    edge non-empty; binding to a fleet also requires the ids to cover
    exactly ``range(n_clients)`` (:meth:`validate`)."""
    edges: tuple[tuple[int, ...], ...]

    def __post_init__(self):
        object.__setattr__(self, "edges",
                           tuple(tuple(int(c) for c in e)
                                 for e in self.edges))
        if not self.edges:
            raise ValueError("FleetTopology needs at least one edge group")
        seen: set[int] = set()
        for e, ids in enumerate(self.edges):
            if not ids:
                raise ValueError(f"edge group {e} is empty")
            for c in ids:
                if c < 0:
                    raise ValueError(f"negative client id {c} in edge {e}")
                if c in seen:
                    raise ValueError(f"client {c} appears in two edge groups")
                seen.add(c)

    @classmethod
    def contiguous(cls, n_clients: int, n_edges: int) -> "FleetTopology":
        """``range(n_clients)`` in ``n_edges`` contiguous groups
        (``np.array_split`` sizes: remainders go to the first groups)."""
        if not 1 <= n_edges <= n_clients:
            raise ValueError(f"need 1 <= n_edges <= n_clients, got "
                             f"{n_edges} edges for {n_clients} clients")
        return cls(tuple(tuple(int(c) for c in part) for part in
                         np.array_split(np.arange(n_clients), n_edges)))

    @classmethod
    def round_robin(cls, n_clients: int, n_edges: int) -> "FleetTopology":
        """``range(n_clients)`` dealt over ``n_edges`` groups round-robin:
        with a cycling tier pattern every plan reaches every edge."""
        if not 1 <= n_edges <= n_clients:
            raise ValueError(f"need 1 <= n_edges <= n_clients, got "
                             f"{n_edges} edges for {n_clients} clients")
        return cls(tuple(tuple(range(e, n_clients, n_edges))
                         for e in range(n_edges)))

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    @property
    def n_clients(self) -> int:
        return sum(len(e) for e in self.edges)

    def edge_of(self) -> dict[int, int]:
        """client id -> edge index."""
        return {c: e for e, ids in enumerate(self.edges) for c in ids}

    def validate(self, n_clients: int) -> None:
        """The bind-time check: the edge groups partition exactly
        ``range(n_clients)``."""
        ids = sorted(c for e in self.edges for c in e)
        if ids != list(range(n_clients)):
            raise ValueError(
                f"topology covers {len(ids)} client ids "
                f"(max {ids[-1] if ids else '-'}) but the fleet has "
                f"{n_clients} clients 0..{n_clients - 1}")

    def to_dict(self) -> dict:
        return {"edges": [list(e) for e in self.edges]}

    @classmethod
    def from_dict(cls, d: dict) -> "FleetTopology":
        return cls(tuple(tuple(e) for e in d["edges"]))


# ----------------------------------------------------------- edge grids

@dataclass
class EdgeCohort:
    """One plan's clients as an ``(E, cap, ...)`` edge grid.

    Duck-types :class:`~repro_torch.core.federated.Cohort` (``plan``,
    ``client_ids``, ``data``, ``profile_names``, ``ef_buffer``,
    ``size``): ``data`` leaves are ``(E, cap, n, ...)`` on the server's
    device (:class:`EdgeBlocks` under a mesh), ``cap`` the largest
    per-edge sub-cohort with short edges padded by zero rows, and the EF
    buffer ``(E, cap, *local_shape)``. ``client_ids`` and
    ``profile_names`` keep the flat cohort's order, so sampling and the
    host Eq. (1) arithmetic are the flat cohort's; only the step sees the
    grid, through the ``(edge_index[i], row_index[i])`` cell of flat
    client ``i`` (host numpy arrays). Padding cells are in no such cell,
    so their participation stays 0."""
    plan: object
    client_ids: tuple[int, ...]
    data: dict
    profile_names: tuple[str, ...]
    edge_index: np.ndarray          # (size,) edge of flat client i
    row_index: np.ndarray           # (size,) grid row of flat client i
    n_edges: int
    cap: int
    ef_buffer: object = None

    @property
    def size(self) -> int:
        return len(self.client_ids)


def build_edge_cohorts(clients: list, topology: FleetTopology,
                       device) -> list[EdgeCohort]:
    """Group clients by plan (first-appearance order, as ``build_cohorts``)
    and arrange each group as an edge grid on ``device``. Every grid spans
    all ``topology.n_edges`` rows (a plan absent from an edge gets a padded
    row there), so one placement fits every cohort. A group's common shard
    length is its minimum. The grid is stacked on the host in numpy and
    copied to the device once per leaf, not once per client."""
    topology.validate(len(clients))
    edge_of = topology.edge_of()
    groups: dict = {}
    for c in clients:
        groups.setdefault(c.plan, []).append(c)
    E = topology.n_edges
    out = []
    for plan, cs in groups.items():
        n = min(next(iter(c.data.values())).shape[0] for c in cs)
        edge_idx = np.array([edge_of[c.id] for c in cs], np.int64)
        row_idx = np.zeros(len(cs), np.int64)
        fill = np.zeros(E, np.int64)
        for i, e in enumerate(edge_idx):
            row_idx[i] = fill[e]
            fill[e] += 1
        cap = max(1, int(fill.max()))
        data = {}
        for k, v0 in cs[0].data.items():
            leaf0 = np.asarray(v0)
            grid = np.zeros((E, cap, n) + leaf0.shape[1:], leaf0.dtype)
            for i, c in enumerate(cs):
                grid[edge_idx[i], row_idx[i]] = np.asarray(c.data[k])[:n]
            data[k] = torch.from_numpy(grid).to(device)
        out.append(EdgeCohort(plan=plan,
                              client_ids=tuple(c.id for c in cs),
                              data=data,
                              profile_names=tuple(c.profile_name
                                                  for c in cs),
                              edge_index=edge_idx, row_index=row_idx,
                              n_edges=E, cap=cap))
    return out


def scatter_part(cohort: EdgeCohort, part_flat) -> np.ndarray:
    """A flat participation mask (the sampler's order) scattered into the
    cohort's ``(E, cap)`` float32 grid; padding cells stay 0."""
    part_flat = np.asarray(part_flat)
    grid = np.zeros((cohort.n_edges, cohort.cap), np.float32)
    grid[cohort.edge_index, cohort.row_index] = part_flat.astype(np.float32)
    return grid


# ------------------------------------------------------------ placement

@dataclass(frozen=True)
class EdgeMesh:
    """The port's edge mesh: block ``b`` of every edge axis lives on
    ``devices[b]``; ``devices[0]`` is the hub, where the params, the
    optimizer state and the fixed-order combine stay. A device may appear
    more than once (several blocks on one card)."""
    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def hub(self) -> torch.device:
        return self.devices[0]

    def bounds(self, n_edges: int) -> list[tuple[int, int]]:
        """Each block's ``[lo, hi)`` edges: contiguous and equal."""
        per = n_edges // self.size
        return [(b * per, (b + 1) * per) for b in range(self.size)]


class EdgeBlocks:
    """A tensor whose leading edge axis is split into the contiguous
    blocks of an :class:`EdgeMesh`, each on its device: the port's
    counterpart of an array sharded over the mesh's ``"data"`` axis.
    ``shape`` and ``dtype`` read as the whole tensor's."""
    __slots__ = ("blocks",)

    def __init__(self, blocks):
        self.blocks = tuple(blocks)

    @property
    def shape(self) -> torch.Size:
        b0 = self.blocks[0]
        return torch.Size((sum(b.shape[0] for b in self.blocks),)
                          + tuple(b0.shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    def gather(self, device) -> torch.Tensor:
        """The whole tensor on ``device``."""
        return torch.cat([b.to(device) for b in self.blocks])


def edge_blocks(t) -> tuple:
    """The per-block tensors of a grid leaf: an :class:`EdgeBlocks`'
    blocks, or a plain tensor as its one block."""
    return t.blocks if isinstance(t, EdgeBlocks) else (t,)


def unshard(t, device):
    """A grid leaf as one tensor on ``device``."""
    return t.gather(device) if isinstance(t, EdgeBlocks) else t.to(device)


def make_edge_mesh(n_edges: int, devices=None) -> EdgeMesh:
    """An :class:`EdgeMesh` over the largest divisor of ``n_edges`` that
    fits the devices, so each holds a whole number of edges. ``devices``
    defaults to every CUDA device (one on a one-card host); without a GPU
    the caller must pass devices (e.g. ``[torch.device("cpu")] * 2``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices= "
                               "(e.g. [torch.device('cpu')] * 2) to mesh "
                               "the edges on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_edge_mesh needs at least one device")
    d = max(k for k in range(1, min(n_edges, len(devices)) + 1)
            if n_edges % k == 0)
    return EdgeMesh(tuple(devices[:d]))


@dataclass(frozen=True)
class EdgeSharding:
    """Places a tensor's leading edge axis over a mesh's blocks."""
    mesh: EdgeMesh

    def put(self, t: torch.Tensor) -> EdgeBlocks:
        """``t`` split into the mesh's blocks, one copy per block."""
        return EdgeBlocks(t[lo:hi].to(dev) for (lo, hi), dev in
                          zip(self.mesh.bounds(t.shape[0]), self.mesh.devices))


@dataclass(frozen=True)
class ReplicatedSharding:
    """Keeps a tensor on the mesh's hub device; each block's step takes
    its own copy of the params there, once a round."""
    mesh: EdgeMesh

    def put(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.mesh.hub)


def edge_sharding(mesh: EdgeMesh) -> EdgeSharding:
    """The placement of a leading edge axis over ``mesh``'s blocks."""
    return EdgeSharding(mesh)


def replicated_sharding(mesh: EdgeMesh) -> ReplicatedSharding:
    return ReplicatedSharding(mesh)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree)


def shard_fleet(server, mesh: EdgeMesh | None = None):
    """Place a topology server on ``mesh``: every edge grid (cohort data
    and EF rows) in the mesh's blocks, params and optimizer state on the
    hub. Only placement changes: each edge is computed in the same shapes
    either way, so the run stays bitwise the unsharded one. ``mesh``
    defaults to :func:`make_edge_mesh` over the server's device type (the
    CUDA devices, or the one CPU). Returns the server."""
    cohorts = list(getattr(server, "cohorts", ()))
    grids = [c for c in cohorts if isinstance(c, EdgeCohort)]
    if not grids or len(grids) != len(cohorts):
        raise ValueError("shard_fleet needs a topology server (every "
                         "cohort an EdgeCohort); build it with "
                         "FleetSpec(topology=...) / build_edge_cohorts")
    if mesh is None:
        dev = server.device
        mesh = make_edge_mesh(grids[0].n_edges,
                              None if dev.type == "cuda" else [dev])
    for c in grids:
        if c.n_edges % mesh.size:
            raise ValueError(
                f"{c.n_edges} edges do not divide over {mesh.size} mesh "
                f"devices; use make_edge_mesh")
    sh, rep = edge_sharding(mesh), replicated_sharding(mesh)
    for c in grids:
        c.data = {k: sh.put(v) for k, v in c.data.items()}
        if c.ef_buffer is not None:
            c.ef_buffer = {k: sh.put(v) for k, v in c.ef_buffer.items()}
    server.params = _tree_map(rep.put, server.params)
    server.opt_state = _tree_map(rep.put, server.opt_state)
    server.mesh = mesh
    return server


# -------------------------------------------------------- traffic model

def cross_shard_bytes(params, plans, n_edges: int) -> float:
    """Analytic edge -> hub traffic per round, in bytes: each (plan, edge)
    forwards one f32 update tree and one f32 mask tree at the plan's
    local shapes, and one f32 loss partial. Shape arithmetic on the host:
    ``params`` is a name -> tensor dict (the ``meta`` device will do) or
    name -> shape; independent of the client count by construction.
    ``plans`` are the fleet's distinct plans (one grid each)."""
    from repro_torch.core.compression import submodel_spec
    params = {k: v if isinstance(v, torch.Tensor)
              else torch.empty(tuple(v), device="meta")
              for k, v in params.items()}
    total = 0
    for plan in plans:
        if plan.structured:
            n_local = submodel_spec(params, plan.width).local_size()
        else:
            n_local = sum(math.prod(p.shape) for p in params.values())
        total += n_edges * (2 * 4 * n_local + 4)
    return float(total)
