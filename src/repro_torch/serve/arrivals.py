"""Arrival processes for the online serving engine (port of
`repro.serve.arrivals`, pure host code: the draws equal the reference's).

Every throughput number before this module came from offline replay at a
fixed batch size; real serving sees requests *arrive* — and the latency a
user experiences is queueing + batching + service, not just service.
This module generates the arrival side of that story on the same virtual
millisecond clock the resilient tier introduced (repro_torch.serve.remote):
nothing sleeps, every timestamp is derived from a seeded schedule, and a
run is replayable bit-for-bit.

Three registered kinds (`ARRIVAL_KINDS`):

* ``poisson`` — the open-loop memoryless process of the similarity-
  caching performance models: i.i.d. exponential inter-arrivals at
  `rate_rps` requests/second.
* ``flash_crowd`` — an open-loop *modulated* Poisson process: a periodic
  burst train multiplies the instantaneous rate by `burst_factor` for
  `burst_width_ms` out of every `burst_every_ms` (the arrival-side twin
  of the flash_crowd trace scenario's popularity shocks).  The base rate
  is normalised so the *mean* offered load equals `rate_rps`, keeping
  load sweeps comparable across kinds.
* ``closed_loop`` — `users` concurrent clients, each submitting one
  request, waiting for its completion plus an exponential think time
  (`think_ms` mean), then submitting the next.  Arrival times emerge
  from completions, so this kind is driven by the engine through the
  `ArrivalSource` protocol rather than precomputed.

Determinism: open-loop schedules are a pure function of (spec, t) —
`arrival_times` draws all inter-arrival randomness in one pass keyed by
`SeedSequence((seed, tag))`, so the times are identical across machines
and (trivially) independent of the engine's queue-drain order.  The
closed loop keys every think draw by `SeedSequence((seed, user, n))`, so
per-user schedules are order-independent too.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

ARRIVAL_KINDS = ("poisson", "flash_crowd", "closed_loop")

#: dissociates the arrival stream from other consumers of the same seed
_ARRIVAL_TAG = 0xA221


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """Serializable arrival-process selection (the workload-timing twin of
    TraceSpec): kind + rate/burst/think knobs.

    * `rate_rps` — mean offered load of the open-loop kinds (requests per
      *second*; the virtual clock runs in ms).
    * `burst_*` — flash_crowd modulation: every `burst_every_ms` the rate
      multiplies by `burst_factor` for `burst_width_ms`.
    * `users` / `think_ms` — closed-loop population and mean think time.
    * `seed` — the one knob that changes the draw (same seed = same
      schedule, bit for bit).
    """

    kind: str = "poisson"
    rate_rps: float = 1000.0
    burst_factor: float = 8.0
    burst_every_ms: float = 250.0
    burst_width_ms: float = 50.0
    users: int = 8
    think_ms: float = 10.0
    seed: int = 0

    def __post_init__(self):
        if self.kind not in ARRIVAL_KINDS:
            raise ValueError(
                f"unknown arrival kind {self.kind!r}; registered: "
                f"{', '.join(ARRIVAL_KINDS)}")
        if self.kind != "closed_loop" and self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0: {self.rate_rps}")
        if self.kind == "flash_crowd":
            if self.burst_factor < 1.0:
                raise ValueError(
                    f"burst_factor must be >= 1: {self.burst_factor}")
            if not 0 < self.burst_width_ms <= self.burst_every_ms:
                raise ValueError(
                    f"need 0 < burst_width_ms <= burst_every_ms: "
                    f"({self.burst_width_ms}, {self.burst_every_ms})")
        if self.kind == "closed_loop":
            if self.users < 1:
                raise ValueError(f"users must be >= 1: {self.users}")
            if self.think_ms < 0:
                raise ValueError(f"think_ms must be >= 0: {self.think_ms}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ArrivalSpec":
        return cls(**dict(d))


def _unit_exponentials(spec: ArrivalSpec, t: int) -> np.ndarray:
    """The one randomness draw of an open-loop schedule: t unit-mean
    exponential inter-arrival targets, keyed by the spec seed alone."""
    rng = np.random.default_rng(
        np.random.SeedSequence((spec.seed, _ARRIVAL_TAG)))
    return rng.exponential(1.0, size=t)


def _flash_crowd_base_rate_ms(spec: ArrivalSpec) -> float:
    """Base (off-burst) rate in requests/ms such that the *mean* rate of
    the modulated process equals spec.rate_rps."""
    duty = spec.burst_width_ms / spec.burst_every_ms
    mean_factor = 1.0 + (spec.burst_factor - 1.0) * duty
    return (spec.rate_rps / 1e3) / mean_factor


def arrival_times(spec: ArrivalSpec, t: int) -> np.ndarray:
    """Open-loop arrival schedule: (t,) nondecreasing virtual-ms floats.

    Poisson inverts the constant cumulative rate directly; flash_crowd
    inverts the piecewise-constant cumulative rate segment by segment
    (time-rescaling theorem: arrivals of an inhomogeneous Poisson process
    are unit-exponential gaps in integrated-rate space).  Raises for
    closed_loop — its times emerge from completions (`ClosedLoopSource`).
    """
    if spec.kind == "closed_loop":
        raise ValueError(
            "closed_loop arrival times depend on completions; drive the "
            "engine with ClosedLoopSource(spec, t) instead")
    gaps = _unit_exponentials(spec, t)
    if spec.kind == "poisson":
        return np.cumsum(gaps) / (spec.rate_rps / 1e3)
    # flash_crowd: walk the piecewise-constant rate r(tau)
    base = _flash_crowd_base_rate_ms(spec)
    burst = base * spec.burst_factor
    every, width = spec.burst_every_ms, spec.burst_width_ms
    out = np.empty(t, np.float64)
    tau = 0.0   # current virtual time (ms)
    acc = 0.0   # integrated rate up to tau (expected arrival count)
    targets = np.cumsum(gaps)
    for i, s in enumerate(targets):
        while True:
            phase = tau % every
            in_burst = phase < width
            r = burst if in_burst else base
            seg_end = tau - phase + (width if in_burst else every)
            cap = acc + r * (seg_end - tau)
            if s <= cap:
                tau += (s - acc) / r
                acc = s
                break
            tau, acc = seg_end, cap
        out[i] = tau
    return out


class OpenLoopSource:
    """ArrivalSource over a precomputed time schedule (poisson /
    flash_crowd, or an explicit times array from a test).  Request ids
    are trace positions, assigned in schedule order."""

    def __init__(self, times: np.ndarray):
        self._times = np.asarray(times, np.float64)
        if len(self._times) and (np.diff(self._times) < 0).any():
            raise ValueError("arrival times must be nondecreasing")
        self._i = 0

    def peek(self) -> Optional[float]:
        """Time of the next scheduled arrival (None = exhausted)."""
        if self._i >= len(self._times):
            return None
        return float(self._times[self._i])

    def pop(self) -> Tuple[float, int]:
        """Consume the next arrival: (time_ms, request id)."""
        i = self._i
        self._i += 1
        return float(self._times[i]), i

    def on_complete(self, rid: int, done_ms: float) -> None:
        """Open loops ignore completions (arrivals are exogenous)."""


class ClosedLoopSource:
    """ArrivalSource for the closed loop: `users` clients, each cycling
    submit -> wait for completion -> think -> submit, up to `t` total
    requests.  The engine reports completions through `on_complete`
    (which schedules that user's next arrival), so offered load adapts
    to service capacity — the self-limiting regime open loops can't
    model.  Think draws are keyed per (seed, user, cycle), so a user's
    schedule never depends on other users' drain order."""

    def __init__(self, spec: ArrivalSpec, t: int):
        if spec.kind != "closed_loop":
            raise ValueError(f"ClosedLoopSource needs kind='closed_loop', "
                             f"got {spec.kind!r}")
        self.spec = spec
        self.budget = int(t)
        self._heap: List[Tuple[float, int]] = []  # (time, user)
        self._user_of: Dict[int, int] = {}        # rid -> user
        self._cycle = [0] * spec.users            # per-user think counter
        self._next_rid = 0
        for u in range(min(spec.users, self.budget)):
            # staggered cold start: each user begins after one think time
            heapq.heappush(self._heap, (self._think(u), u))

    def _think(self, u: int) -> float:
        n = self._cycle[u]
        self._cycle[u] += 1
        if self.spec.think_ms == 0:
            return 0.0
        rng = np.random.default_rng(
            np.random.SeedSequence((self.spec.seed, _ARRIVAL_TAG, u, n)))
        return float(rng.exponential(self.spec.think_ms))

    def peek(self) -> Optional[float]:
        if not self._heap or self._next_rid >= self.budget:
            return None
        return self._heap[0][0]

    def pop(self) -> Tuple[float, int]:
        time_ms, u = heapq.heappop(self._heap)
        rid = self._next_rid
        self._next_rid += 1
        self._user_of[rid] = u
        return time_ms, rid

    def on_complete(self, rid: int, done_ms: float) -> None:
        """Schedule the user's next request one think time after this
        one resolved — served *or* shed (a shed user retries), which
        keeps the closed population constant.  Guarded against double
        completion of the same rid."""
        if self._next_rid >= self.budget:
            return
        u = self._user_of.pop(rid, None)
        if u is None:
            return
        heapq.heappush(self._heap, (done_ms + self._think(u), u))


def make_source(spec_or_times, t: int):
    """Normalise any arrival description to an ArrivalSource: an
    `ArrivalSpec` (open kinds precompute `arrival_times`; closed_loop
    builds a `ClosedLoopSource`), a raw times array, or a ready source
    (anything with peek/pop/on_complete) passed through."""
    if isinstance(spec_or_times, ArrivalSpec):
        if spec_or_times.kind == "closed_loop":
            return ClosedLoopSource(spec_or_times, t)
        return OpenLoopSource(arrival_times(spec_or_times, t))
    if hasattr(spec_or_times, "peek") and hasattr(spec_or_times, "pop"):
        return spec_or_times
    return OpenLoopSource(np.asarray(spec_or_times, np.float64)[:t])
