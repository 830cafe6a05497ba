from repro_torch.kernels.codebook_matmul.ops import codebook_matmul  # noqa: F401
