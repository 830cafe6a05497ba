"""PyTorch / CUDA port of the ``repro`` federated-learning framework.

It mirrors ``src/repro`` file for file where a module has been ported,
imports ``torch`` and numpy only (never ``jax``, never ``repro``), and
runs on ``cuda`` unless the caller passes ``device="cpu"``. The
aggregation kernels on the FL round's path are hand-written CUDA for
Hopper (``csrc/``), built with ``nvcc`` at first use.
"""
