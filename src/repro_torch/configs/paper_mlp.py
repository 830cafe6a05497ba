"""The paper's own experimental model (§6.1): 5-layer MLP, 10 neurons per
layer, sigmoid activations, binary classification over 5 Gaussian
features."""
from dataclasses import dataclass


@dataclass(frozen=True)
class MLPConfig:
    name: str = "paper-mlp"
    num_features: int = 5
    num_layers: int = 5           # hidden layers
    hidden: int = 10
    num_classes: int = 2
    activation: str = "sigmoid"


def config() -> MLPConfig:
    return MLPConfig()


def smoke_config() -> MLPConfig:
    return MLPConfig(name="paper-mlp-smoke", num_layers=2)

