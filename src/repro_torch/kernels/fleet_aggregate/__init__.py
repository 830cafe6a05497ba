from repro_torch.kernels.fleet_aggregate.ops import fleet_aggregate  # noqa: F401
