"""The port's FL round end to end against the reference, for the FedAvg
and quantized-upload-with-error-feedback scenarios (the parity check
itself lives in test_torch_slice.py)."""
import pytest
import torch

from test_torch_slice import ENGINES, check_slice_parity

torch.set_num_threads(1)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ["fedavg", "quant_ef"])
def test_slice_matches_reference(name, engine):
    check_slice_parity(name, engine)
