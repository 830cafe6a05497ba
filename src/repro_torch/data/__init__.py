from repro_torch.data.gaussian import make_gaussian_dataset  # noqa: F401
from repro_torch.data.federated import partition_iid, stack_shards  # noqa: F401
from repro_torch.data.synthetic import TokenStream, make_train_batch  # noqa: F401
