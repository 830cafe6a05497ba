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
"""
from repro_torch.core.compression import (CompressionPlan, DEVICE_TIERS,
                                          SubmodelSpec, default_tier_plans,
                                          expand_update, submodel_spec)  # noqa: F401
from repro_torch.core.engine import (ScanEngine, WindowScanEngine,
                                     simulate_rounds)  # noqa: F401
from repro_torch.core.federated import (AsyncFLServer, Client, Cohort,
                                        CohortFLServer, FLServer,
                                        build_cohorts,
                                        window_groups)  # noqa: F401
from repro_torch.core.heterogeneity import (PROFILES, DeviceProfile,
                                            cohort_round_time, fits,
                                            memory_overhead,
                                            round_time)  # noqa: F401
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
