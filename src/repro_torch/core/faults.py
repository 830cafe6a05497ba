"""Declarative fault injection for the federated runtimes: the port's
copy of the reference's ``core/faults.py``.

:class:`FaultPolicy` is the reference's, field for field, with the same
validation and the same ``to_dict``/``from_dict`` wire format. The
machinery has two halves:

HOST side (numpy, stateless per round): every draw is seeded by
``(policy.seed, tag, round)`` through ``np.random.default_rng`` with the
reference's stream tags 11-15, so the masks here are the reference's
arrays, draw for draw, for any round in any order. The engines replay
them per chunk, and a checkpoint needs no fault RNG state: the round
counter is the state.

  - availability traces: a seeded per-client diurnal phase plus
    crash-and-rejoin churn epochs. Sampling still draws the same stream;
    availability then zeros the unavailable rows.
  - mid-round dropouts: a selected client crashes before upload; its
    Eq. (1) time still burns the round wall-clock.
  - corrupted uploads: a seeded subset of clients per round (per upload
    sequence number for the async runtime).

DEVICE side (torch, over name -> ``(C, ...)`` tensor dicts): corruption
writes NaN / +Inf / an exponent bit-flip into the flagged rows;
:func:`finite_guard` zeroes non-finite coordinates and returns their 0/1
coverage, which the aggregation takes out of the denominator;
:func:`clip_updates` clips each client's global L2 norm.

At ``corrupt_frac == 1`` (the default) :func:`inject_corruption` is the
reference's bit for bit. Below 1 the element subset is the port's own
stateless draw, a 32-bit integer hash of ``(seed, uid, leaf index,
element index)`` (:func:`_subset_hash`); the reference keys
``jax.random`` by the same values, which torch cannot reproduce, so the
two packages poison different elements of the same uploads there.

Clean scenarios (``faults=None``) never enter this module.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "FaultPolicy", "availability_mask", "dropout_mask", "corrupt_mask",
    "corrupt_seq_mask", "inject_corruption", "finite_guard",
    "clip_updates",
]

# rng stream tags: one disjoint ``default_rng([seed, TAG, ...])`` family
# per fault axis (16 is the scheduler's retry stream)
_TAG_PHASE = 11       # per-client diurnal phase (drawn once, no round)
_TAG_CHURN = 12       # per-round crash draws
_TAG_DROP = 13        # per-round mid-round dropout draws
_TAG_CORRUPT = 14     # per-round (sync) corruption draws
_TAG_CORRUPT_SEQ = 15  # per-upload-seq (async) corruption draws

CORRUPT_KINDS = ("nan", "inf", "bitflip")


@dataclass(frozen=True)
class FaultPolicy:
    """What goes wrong, and what the server does about it.

    Attack axes (all off by default; every draw is seeded by ``seed``):

    - ``period``/``duty_cycle``: diurnal availability — client ``c`` is
      up for ``ceil(duty_cycle * period)`` of every ``period`` rounds,
      at a seeded per-client phase. ``period=0`` disables the trace.
    - ``churn_rate``/``rejoin_after``: crash-and-rejoin epochs — each
      round a client crashes with probability ``churn_rate`` and stays
      dark for ``rejoin_after`` rounds.
    - ``dropout_rate``: a selected client crashes before upload; its
      Eq. (1) time still burns the round wall-clock (and the deadline
      budget under ``SyncDrop``). On the async virtual clock the same
      rate drops uploads instead: a dropped upload retries at
      ``t + retry_backoff * 2^attempt`` (``max_retries`` retries, the
      last attempt always lands).
    - ``corrupt_rate``/``corrupt_kind``/``corrupt_frac``: each upload is
      poisoned with probability ``corrupt_rate``; within it a seeded
      ``corrupt_frac`` fraction of elements becomes NaN (``"nan"``),
      +Inf (``"inf"``), or has its top exponent bit flipped
      (``"bitflip"``: non-finite and huge-but-finite values).

    Defense knobs:

    - ``finite_guard``: quarantine non-finite upload coordinates with
      per-element 0/1 masks (numerator zeroed, coverage removed from the
      denominator). On by default; active whenever the per-client upload
      path runs (``corrupt_rate > 0`` or ``clip_norm`` set).
    - ``clip_norm``: per-client global-L2 norm clip of the upload.
    """
    seed: int = 0
    # availability trace
    period: int = 0
    duty_cycle: float = 1.0
    # crash-and-rejoin churn
    churn_rate: float = 0.0
    rejoin_after: int = 1
    # mid-round dropout (sync) / upload drop with retry (async)
    dropout_rate: float = 0.0
    retry_backoff: float = 0.0
    max_retries: int = 3
    # corrupted uploads
    corrupt_rate: float = 0.0
    corrupt_kind: str = "nan"
    corrupt_frac: float = 1.0
    # defenses
    finite_guard: bool = True
    clip_norm: float | None = None

    def __post_init__(self):
        if self.period < 0:
            raise ValueError("period must be >= 0 rounds (0 = no trace)")
        if not 0.0 < self.duty_cycle <= 1.0:
            raise ValueError(f"duty_cycle must be in (0, 1], got {self.duty_cycle}")
        if not 0.0 <= self.churn_rate < 1.0:
            raise ValueError(f"churn_rate must be in [0, 1), got {self.churn_rate}")
        if self.rejoin_after < 1:
            raise ValueError("rejoin_after must be >= 1 rounds")
        if not 0.0 <= self.dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got {self.dropout_rate}")
        if self.retry_backoff < 0.0:
            raise ValueError("retry_backoff must be >= 0 seconds")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if not 0.0 <= self.corrupt_rate <= 1.0:
            raise ValueError(f"corrupt_rate must be in [0, 1], got {self.corrupt_rate}")
        if self.corrupt_kind not in CORRUPT_KINDS:
            raise ValueError(f"corrupt_kind must be one of {CORRUPT_KINDS}, "
                             f"got {self.corrupt_kind!r}")
        if not 0.0 < self.corrupt_frac <= 1.0:
            raise ValueError(f"corrupt_frac must be in (0, 1], got {self.corrupt_frac}")
        if self.clip_norm is not None and self.clip_norm <= 0.0:
            raise ValueError("clip_norm must be > 0")

    @property
    def traces_availability(self) -> bool:
        """True when the policy carries a round-indexed availability
        trace (diurnal schedule or churn): sync only, the async virtual
        clock has no round index."""
        return self.period > 0 or self.churn_rate > 0.0

    @property
    def touches_uploads(self) -> bool:
        """True when uploads must flow through the per-client fault path
        (injection and/or defenses) instead of the plain cohort step."""
        return self.corrupt_rate > 0.0 or self.clip_norm is not None

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPolicy":
        return cls(**d)


# ------------------------------------------------------------------ host

def availability_mask(policy: FaultPolicy, n_clients: int,
                      step: int) -> np.ndarray:
    """(n_clients,) bool, True = client is up in round ``step``: up iff
    ``(step + phase[c]) % period < ceil(duty_cycle * period)`` and it
    crashed in none of the last ``rejoin_after`` rounds (one rng per
    round)."""
    up = np.ones(n_clients, bool)
    if policy.period > 0:
        phase = np.random.default_rng(
            [policy.seed, _TAG_PHASE]).integers(0, policy.period, n_clients)
        on = int(np.ceil(policy.duty_cycle * policy.period))
        up &= (step + phase) % policy.period < on
    if policy.churn_rate > 0.0:
        for r in range(max(0, step - policy.rejoin_after + 1), step + 1):
            crash = np.random.default_rng(
                [policy.seed, _TAG_CHURN, r]).random(n_clients)
            up &= crash >= policy.churn_rate
    return up


def dropout_mask(policy: FaultPolicy, n_clients: int,
                 step: int) -> np.ndarray:
    """(n_clients,) bool, True = the client crashes before upload in
    round ``step`` (applies to clients that are sampled and available)."""
    if policy.dropout_rate <= 0.0:
        return np.zeros(n_clients, bool)
    draw = np.random.default_rng(
        [policy.seed, _TAG_DROP, step]).random(n_clients)
    return draw < policy.dropout_rate


def corrupt_mask(policy: FaultPolicy, n_clients: int,
                 step: int) -> np.ndarray:
    """(n_clients,) bool, True = the client's round-``step`` upload is
    poisoned (sync runtimes: one draw per (round, client))."""
    if policy.corrupt_rate <= 0.0:
        return np.zeros(n_clients, bool)
    draw = np.random.default_rng(
        [policy.seed, _TAG_CORRUPT, step]).random(n_clients)
    return draw < policy.corrupt_rate


def corrupt_seq_mask(policy: FaultPolicy, seqs) -> np.ndarray:
    """Per-upload corruption flags for the async runtime, keyed by the
    scheduler's dispatch sequence numbers: a pure per-upload function, so
    the heap path and the window engine poison the same uploads."""
    seqs = np.asarray(seqs)
    if policy.corrupt_rate <= 0.0:
        return np.zeros(seqs.shape, bool)
    out = np.empty(seqs.shape, bool)
    flat = out.reshape(-1)
    for i, s in enumerate(seqs.reshape(-1)):
        flat[i] = (np.random.default_rng(
            [policy.seed, _TAG_CORRUPT_SEQ, int(s)]).random()
            < policy.corrupt_rate)
    return out


# ---------------------------------------------------------------- device

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2^32`` for int64 ``h`` in [0, 2^32): the product is
    split at 16 bits so that no int64 product exceeds 2^48."""
    lo = (h & 0xFFFF) * c
    hi = ((h >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xor-shift-multiply, two rounds) in
    int64 arithmetic: the same bits on every device."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def _subset_hash(seed: int, uid: torch.Tensor, leaf: int,
                 n: int) -> torch.Tensor:
    """(C, n) int64 hashes in [0, 2^32) of ``(seed, uid[c], leaf, i)``
    for the ``n`` elements ``i`` of each row: the port's stateless draw
    of a ``corrupt_frac`` element subset."""
    h = _fmix32(torch.full_like(uid, seed & _M32))
    h = _fmix32(h ^ (uid & _M32))
    h = _fmix32(h ^ leaf)
    idx = torch.arange(n, dtype=torch.int64, device=uid.device)
    return _fmix32(h[:, None] ^ idx[None, :])


def _bad_values(x: torch.Tensor, kind: str) -> torch.Tensor:
    """A leaf's worth of poison. ``bitflip`` flips the top exponent bit
    of each f32 element (exponents >= 127 give Inf/NaN patterns, smaller
    ones huge-but-finite values); non-f32 leaves take +Inf."""
    if kind == "nan":
        return torch.full_like(x, float("nan"))
    if kind == "bitflip" and x.dtype == torch.float32:
        return (x.view(torch.int32) ^ (1 << 30)).view(torch.float32)
    return torch.full_like(x, float("inf"))


def inject_corruption(updates: dict, corrupt: torch.Tensor,
                      uid: torch.Tensor, policy: FaultPolicy) -> dict:
    """Poison the flagged rows of per-client stacked uploads.

    ``updates``: name -> ``(C, ...)``; ``corrupt``: ``(C,)`` f32 0/1 row
    flags; ``uid``: ``(C,)`` int64 per-upload identifiers
    (``step * n_clients + flat_client`` for the sync runtimes, the
    scheduler's dispatch sequence number for async). Below
    ``corrupt_frac == 1`` the element subset is keyed by
    ``(policy.seed, uid, leaf index)`` (:func:`_subset_hash`), so two
    runs that agree on uids poison the same elements."""
    hit = corrupt > 0
    thresh = int(policy.corrupt_frac * 2.0 ** 32)
    out = {}
    for li, (k, u) in enumerate(updates.items()):
        sel = hit.reshape((-1,) + (1,) * (u.dim() - 1))
        if policy.corrupt_frac < 1.0:
            n = u[0].numel()
            sub = _subset_hash(policy.seed, uid, li, n) < thresh
            sel = sel & sub.reshape(u.shape)
        out[k] = torch.where(sel, _bad_values(u, policy.corrupt_kind), u)
    return out


def finite_guard(updates: dict) -> tuple[dict, dict]:
    """Quarantine non-finite coordinates: ``(zeroed, cov)``, where
    ``zeroed`` holds exact 0 in place of every non-finite element and
    ``cov`` is the per-element 0/1 finite-coverage mask (f32). Strictly
    0/1, so the aggregation's mask products stay exact."""
    zeroed, cov = {}, {}
    for k, x in updates.items():
        fin = torch.isfinite(x)
        zeroed[k] = torch.where(fin, x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
        cov[k] = fin.to(torch.float32)
    return zeroed, cov


def clip_updates(updates: dict, clip_norm: float) -> dict:
    """Per-client global-L2 norm clip of stacked ``(C, ...)`` uploads:
    ``u * clip / max(||u||, clip)``, so an all-zero row stays zero. Each
    leaf's squares are summed by ``torch.sum`` (another order than the
    reference's reduction) and the leaves added in dict order."""
    sq = None
    for x in updates.values():
        s = x * x if x.dim() == 1 else torch.sum(x * x,
                                                  dim=tuple(range(1, x.dim())))
        sq = s if sq is None else sq + s
    clip = torch.tensor(clip_norm, dtype=torch.float32, device=sq.device)
    scale = clip / torch.maximum(torch.sqrt(sq), clip)
    return {k: x * scale.reshape((-1,) + (1,) * (x.dim() - 1))
            for k, x in updates.items()}
