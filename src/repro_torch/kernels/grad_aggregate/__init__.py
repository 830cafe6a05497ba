from repro_torch.kernels.grad_aggregate.ops import grad_aggregate  # noqa: F401
