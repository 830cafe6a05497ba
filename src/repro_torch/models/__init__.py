from repro_torch.models.registry import get_model  # noqa: F401
