from repro_torch.core.compression.plan import (CompressionPlan, DEVICE_TIERS,
                                               default_tier_plans,
                                               plan_arrays)  # noqa: F401
from repro_torch.core.compression.pruning import magnitude_mask  # noqa: F401
from repro_torch.core.compression.quantization import fake_quant_ste  # noqa: F401
from repro_torch.core.compression.clustering import (cluster_ste,
                                                     kmeans_codebook)  # noqa: F401
from repro_torch.core.compression.structured import (SubmodelSpec,
                                                     compressible,
                                                     expand_masks,
                                                     expand_update,
                                                     slice_submodel,
                                                     slice_tree,
                                                     submodel_spec)  # noqa: F401
from repro_torch.core.compression.apply import (active_param_count,
                                                compress_params,
                                                compress_with_masks,
                                                payload_bits)  # noqa: F401
