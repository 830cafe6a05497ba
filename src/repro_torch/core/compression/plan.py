"""Compression plans: one per device tier (the paper's device heterogeneity).

A plan combines the paper's three techniques — pruning (keep-density),
quantization (any (e,m) float format or int-k), clustering (k-means
codebook) — to different degrees per tier, plus the structured axis
(``width``): a width-sliced dense sub-model instead of a full-shape mask.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

from repro_torch.numerics import FORMATS


@dataclass(frozen=True)
class CompressionPlan:
    name: str
    density: float = 1.0          # pruning keep-fraction (1.0 = no pruning)
    quant: str | None = None      # float format name, "intK", or None
    cluster_k: int = 0            # k-means codebook size (0 = off)
    weight: float = 1.0           # aggregation weight (e.g. #devices in tier)
    # structured sub-model width: None = masked emulation (full-shape
    # arrays); w in (0, 1] = the device trains a dense width-w prefix
    # slice of the global model (HeteroFL-style). density/quant/cluster
    # then apply WITHIN the slice.
    width: float | None = None

    def __post_init__(self):
        if self.width is not None and not 0.0 < self.width <= 1.0:
            raise ValueError(f"width must be in (0, 1], got {self.width}")

    @property
    def structured(self) -> bool:
        """True when the plan trains a width-sliced dense sub-model
        (width=1.0 included: a full slice)."""
        return self.width is not None

    def inner(self) -> "CompressionPlan":
        """The plan applied WITHIN the slice (width stripped)."""
        return (dataclasses.replace(self, width=None) if self.structured
                else self)

    def as_width_sliced(self) -> "CompressionPlan":
        """The structured counterpart of a masked plan: spend the density
        budget as a width slice instead (width = density, density = 1.0).
        Already-structured plans are returned unchanged."""
        if self.structured:
            return self
        return dataclasses.replace(self, width=self.density, density=1.0)

    def quant_em(self) -> tuple[int, int]:
        """(e_bits, m_bits); (0, 0) means quantization off."""
        if self.quant is None or self.quant == "fp32":
            return (0, 0)
        if self.quant.startswith("int"):
            # int-k is handled separately; encode as e=0, m=k
            return (0, int(self.quant[3:]))
        f = FORMATS[self.quant]
        return (f.e_bits, f.m_bits)

    @property
    def bits_per_weight(self) -> float:
        """Effective storage bits per (kept) weight — drives the comm model."""
        if self.cluster_k:
            return math.log2(self.cluster_k)
        if self.quant is None or self.quant == "fp32":
            return 32.0
        if self.quant.startswith("int"):
            return float(self.quant[3:])
        return float(FORMATS[self.quant].bits)


# The tier system used throughout: an IoT fleet from server-class hub
# down to MCU-class embedded devices.
DEVICE_TIERS: dict[str, CompressionPlan] = {
    "hub":      CompressionPlan("hub"),
    "high":     CompressionPlan("high", quant="fp8_e4m3", weight=1.0),
    "mid":      CompressionPlan("mid", density=0.5, quant="bf16"),
    "low":      CompressionPlan("low", density=0.25, quant="fp8_e5m2"),
    "embedded": CompressionPlan("embedded", density=0.25, quant="fp4_e2m1",
                                cluster_k=16),
}


def default_tier_plans(n_tiers: int = 4) -> list[CompressionPlan]:
    order = ["hub", "high", "mid", "low", "embedded"]
    return [DEVICE_TIERS[k] for k in order[:n_tiers]]

