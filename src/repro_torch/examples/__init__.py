"""The reference's ``examples/*.py`` as entry points of the port, one
module per script with the same name:

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.hetero_fl_sim
  PYTHONPATH=src python -m repro_torch.examples.paper_mlp_repro
  PYTHONPATH=src python -m repro_torch.examples.serve_quantized
  PYTHONPATH=src python -m repro_torch.examples.train_100m

Each keeps its script's constants, CLI and printed lines, adds one flag,
``--device`` (default ``cuda``; without a GPU it raises unless given
``--device cpu``), and does its work in ``main()`` and the functions
that ``main()`` calls, never at import.
"""

import torch


def sync(device) -> None:
    """Wait for ``device`` (a name or a ``torch.device``) to finish its
    queued work: the examples time their runs between such syncs."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
