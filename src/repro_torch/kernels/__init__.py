"""Hand-written CUDA kernels for Hopper that replace the reference's TPU
kernels:

  - grad_aggregate:     fused mask-aware aggregation of masked fleets
  - structured_scatter: fused prefix-block aggregation of width-sliced
                        (structured) fleets, batched over same-signature
                        leaves
  - fake_quant:         rounding onto a (1, e, m) float grid, the body of
                        every (e, m) fake quantization
  - flash_attention:    online-softmax attention forward (GQA, causal,
                        window, q_offset) of the LM train step
  - masked_matmul:      pruned-weight matmul x @ (w * mask), the mask
                        applied as each w tile is staged; its backward
                        runs the same kernel
  - codebook_matmul:    clustered-weight matmul x @ codebook[idx], the
                        codebook decoded from shared memory

Each subpackage: ``ops.py`` (wrapper with its launch counter) and
``ref.py`` (plain PyTorch version); the CUDA sources are in ``csrc/`` and
``build.py`` compiles them at first use. ``masked_matmul`` and
``codebook_matmul`` are the package's public kernel API, as in the
reference (``from repro_torch.kernels import masked_matmul``); the other
wrappers are imported from their subpackages
(``repro_torch.kernels.grad_aggregate``).
"""
from repro_torch.kernels.masked_matmul.ops import masked_matmul  # noqa: F401
from repro_torch.kernels.codebook_matmul.ops import codebook_matmul  # noqa: F401
