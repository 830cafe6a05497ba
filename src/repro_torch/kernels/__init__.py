"""Hand-written CUDA kernels for Hopper that replace the reference's TPU
kernels on the FL round's path:

  - grad_aggregate:     fused mask-aware aggregation of masked fleets
  - structured_scatter: fused prefix-block aggregation of width-sliced
                        (structured) fleets, batched over same-signature
                        leaves

Each subpackage: ``ops.py`` (wrapper with its launch counter) and
``ref.py`` (plain PyTorch version); the CUDA sources are in ``csrc/`` and
``build.py`` compiles them at first use. The wrappers are imported
from their subpackages (``repro_torch.kernels.grad_aggregate``), so a
subpackage name is never shadowed by its function.
"""
