"""Hand-written CUDA kernels for Hopper that replace the reference's TPU
kernels on the port's paths:

  - grad_aggregate:     fused mask-aware aggregation of masked fleets
  - structured_scatter: fused prefix-block aggregation of width-sliced
                        (structured) fleets, batched over same-signature
                        leaves
  - fake_quant:         rounding onto a (1, e, m) float grid, the body of
                        every (e, m) fake quantization
  - flash_attention:    online-softmax attention forward (GQA, causal,
                        window, q_offset) of the LM train step

Each subpackage: ``ops.py`` (wrapper with its launch counter) and
``ref.py`` (plain PyTorch version); the CUDA sources are in ``csrc/`` and
``build.py`` compiles them at first use. The wrappers are imported
from their subpackages (``repro_torch.kernels.grad_aggregate``), so a
subpackage name is never shadowed by its function.
"""
