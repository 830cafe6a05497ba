"""Entry points of the port: ``serve`` and ``train`` (``python -m repro_torch.launch.serve`` / ``.train``)."""
