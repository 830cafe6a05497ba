"""Virtual-clock scheduler for the asynchronous federated runtime
(DESIGN.md §10): the port's own copy of the reference's
``core/schedule.py`` (numpy only), draw for draw the same.

The synchronous runtimes advance in lockstep rounds; the async runtime
advances on an event queue over a *virtual* clock driven by the analytic
Eq. (1) round times (DESIGN.md §8): client c, dispatched at virtual time
``t`` against global version ``v``, lands its upload at
``t + dispatch_time(c, k)``. The server consumes uploads in arrival order
and aggregates once ``buffer_size`` of them are buffered (the FedBuff
shape); the consumed clients then re-download the new global version and
restart at the aggregation time.

The scheduler is pure host-side bookkeeping — no torch, no device work —
and fully deterministic given ``(times, buffer_size, seed, jitter)``:
ties in arrival time break on the dispatch sequence number, and the
per-dispatch lognormal jitter is seeded per ``(seed, client, dispatch)``.
Determinism is property-tested against a list-scan reference simulator in
``tests/test_async.py``, and this copy against the reference's in
``tests/test_torch_async.py``.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass(frozen=True)
class Upload:
    """One client's finished local round arriving at the server."""
    t: float            # virtual arrival time (seconds)
    seq: int            # dispatch sequence number — deterministic tie-break
    client: int         # scheduler client index (position in ``times``)
    version: int        # global model version the client trained against


@dataclass(frozen=True)
class Window:
    """One buffered aggregation: the uploads consumed, in apply order."""
    t: float            # aggregation time = arrival of the last upload
    version: int        # global version BEFORE this window is applied
    uploads: tuple[Upload, ...]

    @property
    def stalenesses(self) -> tuple[int, ...]:
        """Per-upload staleness s = versions the global advanced since the
        client downloaded (0 for an upload trained on the live version)."""
        return tuple(self.version - u.version for u in self.uploads)


def dispatch_time(base: float, jitter: float, seed: int,
                  client: int, dispatch: int) -> float:
    """Duration of one client dispatch: the analytic base time with an
    optional multiplicative lognormal jitter, seeded per
    ``(seed, client, dispatch)`` so the draw is independent of event
    interleaving (heap and reference simulators compute identical bits)."""
    if jitter <= 0.0:
        return float(base)
    rng = np.random.default_rng([seed, client, dispatch])
    return float(base) * float(np.exp(jitter * rng.standard_normal()))


_RETRY_TAG = 16     # rng stream tag — disjoint from core.faults' tags 11–15


@dataclass(frozen=True)
class RetrySpec:
    """Upload-loss model for the virtual clock (DESIGN.md §17): each
    upload attempt is lost with probability ``drop_rate``; attempt ``a``'s
    retransmission waits ``backoff * 2**a`` seconds. After ``max_retries``
    losses the final attempt always lands — DELAYS, never losses, which
    preserves the scheduler's one-in-flight-upload-per-client invariant
    (and with it the heap ≡ materializer element-wise identity: both add
    the same per-``(seed, client, dispatch)`` delay to the same arrival).
    """
    drop_rate: float
    backoff: float
    max_retries: int
    seed: int = 0

    def delay(self, client: int, dispatch: int) -> float:
        """Total retry delay for a client's ``dispatch``-th upload: a pure
        function of ``(seed, client, dispatch)``, independent of event
        interleaving, exactly like :func:`dispatch_time`'s jitter."""
        if self.drop_rate <= 0.0 or self.max_retries == 0:
            return 0.0
        draws = np.random.default_rng(
            [self.seed, _RETRY_TAG, client, dispatch]
        ).random(self.max_retries)
        delay = 0.0
        for a, u in enumerate(draws):
            if u >= self.drop_rate:
                break               # attempt ``a`` got through
            delay += self.backoff * 2.0 ** a
        return delay


class VirtualClockScheduler:
    """Event-driven async FL schedule over analytic client round times.

    ``times[c]`` is client c's base round time (Eq. 1 ``T``). All clients
    start at t=0 against version 0. ``next_window()`` pops the next
    ``buffer_size`` uploads in ``(t, seq)`` order, advances the global
    version, and restarts exactly the consumed clients at the aggregation
    time against the new version — stragglers keep training against the
    version they last downloaded and never block anyone.
    """

    def __init__(self, times: Sequence[float], buffer_size: int,
                 seed: int = 0, jitter: float = 0.0,
                 retry: RetrySpec | None = None):
        times = [float(t) for t in times]
        if not times:
            raise ValueError("need at least one client")
        if any(t <= 0.0 for t in times):
            raise ValueError("client round times must be positive")
        if not 1 <= buffer_size <= len(times):
            raise ValueError(
                f"buffer_size must be in [1, n_clients={len(times)}], "
                f"got {buffer_size} (more uploads than clients in flight "
                f"would never arrive)")
        self.times = times
        self.buffer_size = buffer_size
        self.seed = seed
        self.jitter = jitter
        self.retry = retry
        self.version = 0
        self._seq = 0
        self._dispatches = [0] * len(times)     # per-client dispatch count
        self._heap: list[tuple[float, int, int, int]] = []  # (t, seq, c, v)
        for c in range(len(times)):
            self._dispatch(c, 0.0)

    @property
    def n_clients(self) -> int:
        return len(self.times)

    def _dispatch(self, client: int, start: float) -> None:
        k = self._dispatches[client]
        self._dispatches[client] += 1
        t = start + dispatch_time(self.times[client], self.jitter,
                                  self.seed, client, k)
        if self.retry is not None:
            t += self.retry.delay(client, k)
        heapq.heappush(self._heap, (t, self._seq, client, self.version))
        self._seq += 1

    def next_window(self) -> Window:
        """Consume the next ``buffer_size`` uploads, advance the version,
        restart the consumed clients at the aggregation time."""
        uploads = tuple(
            Upload(*heapq.heappop(self._heap))
            for _ in range(self.buffer_size))
        win = Window(t=uploads[-1].t, version=self.version, uploads=uploads)
        self.version += 1
        for u in uploads:
            self._dispatch(u.client, win.t)
        return win

    def trace(self, n_windows: int) -> list[Window]:
        """The next ``n_windows`` aggregation windows (advances state)."""
        return [self.next_window() for _ in range(n_windows)]


@dataclass(frozen=True)
class WindowPlan:
    """The next ``n_windows`` aggregation windows of a
    :class:`VirtualClockScheduler`, host-materialized as stacked arrays
    (DESIGN.md §14) — what the window-scan engine runs from.

    Upload columns are in APPLY order (the order the heap pops them), so
    row ``w`` replays window ``w`` exactly: ``client[w, k]`` uploaded a
    round trained against global version ``upload_version[w, k]``, and
    the window is applied against version ``version0 + w``.
    """
    buffer_size: int
    version0: int                   # global version before the first window
    t: np.ndarray                   # (W,) float64 aggregation times
    client: np.ndarray              # (W, K) int32 upload clients, apply order
    upload_t: np.ndarray            # (W, K) float64 arrival times
    upload_seq: np.ndarray          # (W, K) int64 dispatch sequence numbers
    upload_version: np.ndarray      # (W, K) int64 trained-against versions
    n_versions_live: np.ndarray     # (W,) int32 live versions AFTER window w
    end_version: np.ndarray         # (n_clients,) in-flight versions at end

    @property
    def n_windows(self) -> int:
        return len(self.t)

    @property
    def staleness(self) -> np.ndarray:
        """(W, K) per-upload staleness s = window version - upload version."""
        w_version = self.version0 + np.arange(self.n_windows)
        return w_version[:, None] - self.upload_version

    @property
    def max_version_lag(self) -> int:
        """The bounded version store's required reach: the largest version
        lag the plan ever READS (a stale upload) or still OWES at the end
        (an in-flight client's downloaded version). A ring buffer of
        ``max_version_lag + 1`` param copies serves every access."""
        end_lag = (self.version0 + self.n_windows) - self.end_version
        read_lag = self.staleness
        return int(max(read_lag.max(initial=0), end_lag.max(initial=0)))


def materialize_windows(sched: VirtualClockScheduler,
                        n_windows: int) -> WindowPlan:
    """Host-precompute ``sched``'s next ``n_windows`` windows as stacked
    arrays WITHOUT advancing the scheduler (DESIGN.md §14).

    Independent implementation on purpose: where the scheduler pops a
    heap event-by-event, this materializer keeps one in-flight upload
    per client (the scheduler's invariant — a client redispatches only
    when consumed) as flat arrays and selects each window with a
    ``np.lexsort`` over ``(t, seq)``. Identical floats by construction —
    window times are ``start + dispatch_time(...)`` with the same
    per-``(seed, client, dispatch)`` draws — and element-wise identity
    with the heap's trace is property-tested in ``tests/test_async.py``
    and ``tests/test_torch_async.py``.
    """
    if n_windows < 1:
        raise ValueError(f"n_windows must be >= 1, got {n_windows}")
    n, K = sched.n_clients, sched.buffer_size
    # snapshot the per-client in-flight state (one heap entry per client)
    t = np.empty(n, np.float64)
    seq = np.empty(n, np.int64)
    ver = np.empty(n, np.int64)
    for (ut, us, uc, uv) in sched._heap:
        t[uc], seq[uc], ver[uc] = ut, us, uv
    disp = list(sched._dispatches)
    next_seq = sched._seq
    v0 = sched.version

    W = n_windows
    out = dict(t=np.empty(W, np.float64),
               client=np.empty((W, K), np.int32),
               upload_t=np.empty((W, K), np.float64),
               upload_seq=np.empty((W, K), np.int64),
               upload_version=np.empty((W, K), np.int64),
               n_versions_live=np.empty(W, np.int32))
    for w in range(W):
        sel = np.lexsort((seq, t))[:K]      # (t, seq) order = apply order
        t_agg = float(t[sel[-1]])           # last consumed upload's arrival
        out["t"][w] = t_agg
        out["client"][w] = sel
        out["upload_t"][w] = t[sel]
        out["upload_seq"][w] = seq[sel]
        out["upload_version"][w] = ver[sel]
        # consumed clients re-download version v0+w+1 and redispatch at
        # the aggregation time, in apply order (seq assignment matters)
        for c in sel:
            t[c] = t_agg + dispatch_time(sched.times[c], sched.jitter,
                                         sched.seed, int(c), disp[c])
            if sched.retry is not None:
                t[c] += sched.retry.delay(int(c), disp[c])
            seq[c] = next_seq
            ver[c] = v0 + w + 1
            disp[c] += 1
            next_seq += 1
        # the eager server's version store after this window: the new
        # current version plus every version an in-flight client still
        # trains against — and the current version is always in-flight
        # (the consumed clients just redispatched on it)
        out["n_versions_live"][w] = len(np.unique(ver))
    return WindowPlan(buffer_size=K, version0=v0, end_version=ver, **out)


def schedule_census(times: Sequence[float], buffer_size: int,
                    n_windows: int, seed: int = 0,
                    jitter: float = 0.0) -> dict:
    """Schedule-only statistics for a fleet: aggregation cadence and the
    staleness profile,
    versus the synchronous-wait cadence of ``max(times)`` per round."""
    if n_windows < 1:
        raise ValueError(f"n_windows must be >= 1, got {n_windows}")
    sched = VirtualClockScheduler(times, buffer_size, seed=seed,
                                  jitter=jitter)
    windows = sched.trace(n_windows)
    stale = [s for w in windows for s in w.stalenesses]
    hist: dict[int, int] = {}
    for s in stale:
        hist[s] = hist.get(s, 0) + 1
    t_end = windows[-1].t
    updates = n_windows * buffer_size
    sync_round = max(sched.times)
    return {
        "n_clients": sched.n_clients,
        "buffer_size": buffer_size,
        "n_windows": n_windows,
        "t_end_s": t_end,
        "updates_per_s": updates / t_end,
        "sync_updates_per_s": sched.n_clients / sync_round,
        "staleness_mean": float(np.mean(stale)),
        "staleness_max": int(max(stale)),
        "staleness_hist": {str(k): v for k, v in sorted(hist.items())},
    }
