from repro_torch.kernels.structured_scatter.ops import (
    structured_scatter, structured_scatter_batched)  # noqa: F401
