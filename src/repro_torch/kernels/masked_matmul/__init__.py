from repro_torch.kernels.masked_matmul.ops import masked_matmul  # noqa: F401
