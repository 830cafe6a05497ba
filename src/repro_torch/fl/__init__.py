"""``repro_torch.fl`` — the one-import surface of the port's federated
runtime:

    from repro_torch.fl import FLScenario, FleetSpec, SyncDrop, simulate

    result = simulate(FLScenario(
        fleet=FleetSpec(tiers=("hub", "high", "mid", "low"), n_samples=1600),
        timing=SyncDrop(deadline=0.5)), rounds=30, engine="scan_pallas")
    print(result.final.loss, result.sim_time, result.agg_backend)

``runtime="client"`` runs the per-client :class:`FLServer`, and
``timing=AsyncBuffered(...)`` the virtual-clock :class:`AsyncFLServer`
(``engine="scan"``: :class:`WindowScanEngine`).

Hierarchical fleets attach a :class:`FleetTopology`
(``FleetSpec(topology=...)`` or ``FleetSpec.cycling(..., edges=E)``):
devices report to edge gateways, each edge forwards one partial
aggregate, and the hub combines them in fixed edge order. The edge grids
may be placed over a mesh of devices, bitwise the unsharded run::

    from repro_torch.fl import make_edge_mesh, simulate

    sc = FLScenario(fleet=FleetSpec.cycling(tiers, 100_000, edges=8))
    result = simulate(sc, 30, engine="scan", mesh=make_edge_mesh(8))

Resilience: a :class:`FaultPolicy` layers availability traces, mid-round
dropouts, corrupted uploads and the server's defences over any scenario,
and ``simulate(..., checkpoint_every=N, checkpoint_dir=...)`` /
``resume_from=...`` make runs durable; a killed and resumed run is
bitwise the uninterrupted one, and the checkpoints are the reference's
format::

    sc = FLScenario(fleet=spec, faults=FaultPolicy(
        period=24, duty_cycle=0.7, churn_rate=0.05,
        dropout_rate=0.1, corrupt_rate=0.01))
    simulate(sc, 1000, checkpoint_every=100, checkpoint_dir="ckpt/")
    simulate(sc, 1000, resume_from="ckpt/")   # continues after a kill

The LM launchers' meshes and shardings are here too, as in the
reference: ``make_host_mesh``, ``batch_axes``, ``num_batch_shards``,
``param_spec_tree`` and ``named``.
"""
from repro_torch.checkpoint import (Checkpointer, load_pytree,
                                    save_pytree)  # noqa: F401
from repro_torch.checkpoint.state import (latest_run_step, restore_run_state,
                                          save_run_state)  # noqa: F401
from repro_torch.core.compression import (CompressionPlan, DEVICE_TIERS,
                                          SubmodelSpec, default_tier_plans,
                                          expand_update, slice_submodel,
                                          submodel_spec)  # noqa: F401
from repro_torch.core.engine import (ScanEngine, WindowScanEngine,
                                     simulate_rounds)  # noqa: F401
from repro_torch.core.faults import FaultPolicy  # noqa: F401
from repro_torch.core.federated import (AsyncFLServer, Client, Cohort,
                                        CohortFLServer, FLServer,
                                        build_cohorts,
                                        window_groups)  # noqa: F401
from repro_torch.core.heterogeneity import (PROFILES, DeviceProfile,
                                            cohort_round_time, fits,
                                            memory_overhead,
                                            round_time)  # noqa: F401
from repro_torch.core.topology import (EdgeBlocks, EdgeCohort, EdgeMesh,
                                       FleetTopology, build_edge_cohorts,
                                       cross_shard_bytes, edge_sharding,
                                       make_edge_mesh, replicated_sharding,
                                       scatter_part,
                                       shard_fleet)  # noqa: F401
from repro_torch.core.scenario import (AsyncBuffered, FleetSpec, FLScenario,
                                       LocalTraining, ParticipationPolicy,
                                       RoundRecord, RunResult, SyncDrop,
                                       SyncWait, TimingPolicy, UploadPolicy,
                                       build_server, resolve_device,
                                       scenario_census, simulate,
                                       timing_from_dict)  # noqa: F401
from repro_torch.core.schedule import (RetrySpec, Upload,
                                       VirtualClockScheduler, Window,
                                       WindowPlan, dispatch_time,
                                       materialize_windows,
                                       schedule_census)  # noqa: F401
from repro_torch.interop import (params_from_numpy, params_to_numpy,
                                 shards_from_numpy)  # noqa: F401
from repro_torch.launch.mesh import (batch_axes, make_host_mesh,
                                     num_batch_shards)  # noqa: F401
from repro_torch.models.sharding import (named, param_spec_tree)  # noqa: F401
