from repro_torch.optim.optimizers import (Optimizer, adam, adamw, momentum,
                                          sgd)  # noqa: F401
