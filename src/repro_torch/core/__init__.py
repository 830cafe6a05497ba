from repro_torch.core.aggregation import hetero_aggregate  # noqa: F401
from repro_torch.core.steps import (TrainState, make_hetero_train_step,
                                    make_prefill_step,
                                    make_serve_step)  # noqa: F401
