"""Device heterogeneity model: tier profiles + the paper's Eq. (1) time
model  T = T_local + T_upload + T_global + T_download, and the on-device
memory model.

Host float64 arithmetic on shapes only, expression for expression the
reference's, so the times and bytes are exactly equal in both packages.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.compression import (CompressionPlan,
                                          active_param_count, payload_bits)


@dataclass(frozen=True)
class DeviceProfile:
    name: str
    flops: float          # sustained FLOP/s for training
    mem_bytes: float      # usable RAM
    up_bps: float         # uplink bits/s
    down_bps: float       # downlink bits/s


PROFILES: dict[str, DeviceProfile] = {
    # server-class IoT hub (small GPU)
    "hub":      DeviceProfile("hub", 5e12, 16e9, 100e6, 100e6),
    # Jetson-class edge accelerator
    "high":     DeviceProfile("high", 5e11, 8e9, 50e6, 50e6),
    # Raspberry Pi 4-class (the paper's reference device)
    "mid":      DeviceProfile("mid", 1e10, 8e9, 20e6, 20e6),
    # Pi Zero-class
    "low":      DeviceProfile("low", 1e9, 5e8, 5e6, 5e6),
    # MCU-class
    "embedded": DeviceProfile("embedded", 1e8, 5e7, 1e6, 1e6),
}

SERVER_FLOPS = 1e14     # aggregation server


def train_flops(n_params: float, tokens_or_samples: float) -> float:
    """~6·N·D for a training pass (fwd+bwd)."""
    return 6.0 * n_params * tokens_or_samples


def _payload_stats(params: dict, plan: CompressionPlan):
    """(n_params, n_active_params, payload bits): shapes only."""
    n_params = sum(math.prod(p.shape) for p in params.values())
    return n_params, active_param_count(params, plan), payload_bits(params, plan)


def round_time(params: dict, plan: CompressionPlan, profile: DeviceProfile,
               n_samples: int, local_steps: int = 1,
               server_flops: float = SERVER_FLOPS) -> dict:
    """Paper Eq. (1), per round, in seconds."""
    n_params, n_active, bits = _payload_stats(params, plan)
    t_local = local_steps * train_flops(n_active, n_samples) / profile.flops
    t_up = bits / profile.up_bps
    t_global = train_flops(n_params, 1) / server_flops     # aggregation pass
    t_down = bits / profile.down_bps
    return {"T_local": t_local, "T_upload": t_up, "T_global": t_global,
            "T_download": t_down,
            "T": t_local + t_up + t_global + t_down,
            "payload_bytes": bits / 8}


@functools.lru_cache(maxsize=4096)
def _eq1_cohort_cached(n_params: int, n_active: float, bits: float,
                       profiles: tuple[DeviceProfile, ...], ns_key,
                       local_steps: int, server_flops: float) -> dict:
    """The arithmetic core of :func:`cohort_round_time`, memoized on its
    hashable inputs. Returned arrays are shared; treat as read-only."""
    flops = np.array([p.flops for p in profiles], np.float64)
    up = np.array([p.up_bps for p in profiles], np.float64)
    down = np.array([p.down_bps for p in profiles], np.float64)
    ns = np.broadcast_to(np.asarray(ns_key, np.float64), flops.shape)
    t_local = local_steps * train_flops(n_active, ns) / flops
    t_up = bits / up
    t_global = np.full_like(flops, train_flops(n_params, 1) / server_flops)
    t_down = bits / down
    return {"T_local": t_local, "T_upload": t_up, "T_global": t_global,
            "T_download": t_down,
            "T": t_local + t_up + t_global + t_down,
            "payload_bytes": np.full_like(flops, bits / 8)}


def cohort_round_time(params: dict, plan: CompressionPlan,
                      profiles: list[DeviceProfile], n_samples,
                      local_steps: int = 1,
                      server_flops: float = SERVER_FLOPS) -> dict:
    """Vectorized Eq. (1) over one cohort (clients sharing ``plan``):
    per-client float64 arrays with :func:`round_time`'s keys. Host numpy
    only; never touches the device."""
    n_params, n_active, bits = _payload_stats(params, plan)
    ns_key = (float(n_samples) if np.ndim(n_samples) == 0
              else tuple(float(x) for x in np.asarray(n_samples).ravel()))
    return dict(_eq1_cohort_cached(n_params, n_active, bits,
                                   tuple(profiles), ns_key, local_steps,
                                   server_flops))


def memory_overhead(params: dict, plan: CompressionPlan, batch: int,
                    act_bytes_per_sample: float = 0.0,
                    opt_slots: int = 0) -> float:
    """Training memory on the device, in bytes: compressed weights +
    grads + ``opt_slots`` optimizer state copies (0 SGD, 1 momentum,
    2 Adam/AdamW) + activations."""
    if opt_slots < 0:
        raise ValueError(f"opt_slots must be >= 0, got {opt_slots}")
    bits = payload_bits(params, plan)
    return (2 + opt_slots) * bits / 8 + batch * act_bytes_per_sample


def fits(params: dict, plan: CompressionPlan, profile: DeviceProfile,
         batch: int = 1, act_bytes_per_sample: float = 0.0,
         opt_slots: int = 0) -> bool:
    """Does training this plan's local model fit the device's RAM?"""
    return memory_overhead(params, plan, batch, act_bytes_per_sample,
                           opt_slots) <= profile.mem_bytes
