from repro_torch.checkpoint.checkpointer import (Checkpointer, load_pytree,
                                                 save_pytree)  # noqa: F401
