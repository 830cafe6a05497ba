from repro_torch.kernels.fake_quant.ops import fake_quant  # noqa: F401
