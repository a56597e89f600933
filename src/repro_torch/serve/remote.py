"""Remote backend: the serving tier's model of the catalog server (port of
`repro.serve.remote`).

AÇAI's premise is an edge cache deciding per request between a local
answer (cost = dissimilarity) and a remote fetch (cost = dissimilarity +
c_f); the paper models the remote server as always reachable.  This
module makes the remote tier explicit so the serving stack
(`repro_torch.serve.resilience`) can reason about its failure:

* `RemoteBackend` — the protocol: `outcome(t, attempt)` describes what
  happens to attempt `attempt` of request `t` (success / transient error /
  corrupt payload / outage, plus a virtual latency), and `fetch(rs, k, t,
  attempt)` transfers an answer (exact kNN ids + distances) when one is
  needed: baselines fetch server answers; AÇAI's indexes are local
  metadata, so its remote calls only move object payloads.
* `OracleRemote` — the healthy server: every outcome succeeds at a fixed
  latency; `fetch` answers through an optional `ServerOracle` (its
  `l2_topk` scan on the card) or any `(rs, k) -> (ids, d2)` callable.
* `FaultyRemote` — a deterministic fault simulator around any inner
  backend.  The schedule is a pure function of `(spec.seed, t, attempt)`
  through `np.random.SeedSequence`, the reference's draw exactly, so
  outcomes are order-independent, replayable and equal to the
  reference's on every machine; a null `FaultSpec` makes every outcome
  `ok`.

Nothing here sleeps: latencies are virtual milliseconds consumed by the
resilience layer's simulated clock.  The module is host code (numpy);
`payload_ok` also checks torch tensors on any device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Protocol, \
    Sequence, Tuple, runtime_checkable

import numpy as np
import torch


class Outcome(NamedTuple):
    """What one attempt of one request experiences at the remote tier."""

    kind: str           # 'ok' | 'error' | 'corrupt' | 'outage'
    latency_ms: float   # virtual time until the outcome surfaces

    @property
    def ok(self) -> bool:
        return self.kind == "ok"


#: outcome kinds that count as remote failures ('corrupt' is a *delivered*
#: payload that fails validation — detected, then treated as a failure so
#: it can never poison OMA state)
FAILURE_KINDS = ("error", "corrupt", "outage")


@runtime_checkable
class RemoteBackend(Protocol):
    """The serving tier's view of the remote catalog server."""

    def outcome(self, t: int, attempt: int = 0) -> Outcome:
        """Fate of attempt `attempt` of request `t` (deterministic)."""
        ...

    def fetch(self, rs: np.ndarray, k: int, t: int = 0,
              attempt: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Transfer the server answer for queries `rs` (B, d): exact kNN
        `(ids (B, k) int32, d2 (B, k) float32)`.  A faulty backend may
        return NaN-poisoned payloads on 'corrupt' outcomes — callers must
        validate with `payload_ok` before consuming."""
        ...


def payload_ok(*arrays) -> bool:
    """Validate fetched payloads: every array (numpy, or a torch tensor on
    any device) finite (no NaN/Inf).  The
    detection half of the corruption failure mode — a payload failing
    this check is treated exactly like a transport error (retry /
    degrade), never handed to the policy state."""
    for a in arrays:
        if a is None:
            return False
        if isinstance(a, torch.Tensor):
            if a.is_floating_point() and not bool(torch.isfinite(a).all()):
                return False
            continue
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating) and not np.isfinite(a).all():
            return False
    return True


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Seeded, deterministic fault schedule for `FaultyRemote`.

    All probabilities / latencies apply per (request, attempt) pair; the
    draw is keyed by `SeedSequence((seed, t, attempt))`, so a retry of
    the same request sees an independent (but reproducible) fate.

    * `latency_ms` / `latency_sigma` — lognormal service latency around
      `latency_ms` (sigma in log-space; 0 = constant).
    * `spike_every` / `spike_width` / `spike_ms` — periodic latency
      spikes: requests with `t % spike_every < spike_width` pay an extra
      `spike_ms` (a garbage-collection / compaction pause train).
    * `error_rate` — transient transport errors (fail fast at
      `error_latency_ms`).
    * `corrupt_rate` — delivered-but-corrupt payloads (full latency paid,
      NaN-poisoned arrays from `fetch`).
    * `outages` — hard outage windows as (start, end) request-index
      pairs: every attempt inside fails fast with kind 'outage'.
    """

    error_rate: float = 0.0
    corrupt_rate: float = 0.0
    latency_ms: float = 5.0
    latency_sigma: float = 0.0
    error_latency_ms: float = 1.0
    spike_every: int = 0
    spike_width: int = 0
    spike_ms: float = 0.0
    outages: Tuple[Tuple[int, int], ...] = ()
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.error_rate <= 1.0:
            raise ValueError(f"error_rate must be in [0, 1]: {self.error_rate}")
        if not 0.0 <= self.corrupt_rate <= 1.0:
            raise ValueError(
                f"corrupt_rate must be in [0, 1]: {self.corrupt_rate}")
        object.__setattr__(
            self, "outages",
            tuple((int(a), int(b)) for a, b in self.outages))
        for a, b in self.outages:
            if a < 0 or b <= a:
                raise ValueError(f"outage window must be 0 <= start < end: "
                                 f"({a}, {b})")

    @property
    def is_null(self) -> bool:
        """True when the schedule can never produce a failure (fault-rate
        0) — the bitwise-parity regime."""
        return (self.error_rate == 0.0 and self.corrupt_rate == 0.0
                and not self.outages)

    def in_outage(self, t: int) -> bool:
        return any(a <= t < b for a, b in self.outages)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["outages"] = [list(w) for w in self.outages]
        return d

    @classmethod
    def from_dict(cls, d) -> "FaultSpec":
        d = dict(d)
        d["outages"] = tuple(tuple(w) for w in d.get("outages", ()))
        return cls(**d)


def parse_outage_windows(specs: Sequence[str]) -> Tuple[Tuple[int, int], ...]:
    """Parse CLI outage windows ('START:END', repeatable) into the
    FaultSpec tuple form, with a clear error on malformed input."""
    out = []
    for s in specs:
        try:
            a, b = s.split(":")
            a, b = int(a), int(b)
        except ValueError:
            raise ValueError(
                f"outage window must be START:END request indices: {s!r}")
        if a < 0 or b <= a:
            raise ValueError(f"outage window needs 0 <= start < end: {s!r}")
        out.append((a, b))
    return tuple(out)


class OracleRemote:
    """The healthy remote server: every attempt succeeds at a fixed
    virtual latency; answers come from `answer_fn` — a `ServerOracle`
    (its `_scan`: the `l2_topk` kernel on the card) or any `(rs, k) ->
    (ids, d2)` callable — when the
    caller actually needs payloads (baselines; AÇAI only needs the
    success/failure signal, its indexes being local)."""

    def __init__(self, answer_fn: Optional[Callable] = None,
                 latency_ms: float = 5.0):
        if answer_fn is not None and not callable(answer_fn):
            # a ServerOracle: route fetches through its fused scan
            oracle = answer_fn

            def answer_fn(rs, k):  # noqa: F811 — adapter closure
                ids, d2 = oracle._scan(np.atleast_2d(
                    np.asarray(rs, np.float32)))
                return ids[:, :k], d2[:, :k]

        self._answer_fn = answer_fn
        self.latency_ms = float(latency_ms)

    def outcome(self, t: int, attempt: int = 0) -> Outcome:
        return Outcome("ok", self.latency_ms)

    def fetch(self, rs: np.ndarray, k: int, t: int = 0, attempt: int = 0):
        if self._answer_fn is None:
            raise ValueError(
                "OracleRemote has no answer_fn: this backend only models "
                "fetch success/failure (AÇAI's indexes are local); pass a "
                "ServerOracle or (rs, k) -> (ids, d2) callable for payloads")
        return self._answer_fn(np.atleast_2d(np.asarray(rs, np.float32)), k)


class FaultyRemote:
    """Deterministic fault injector around an inner `RemoteBackend`.

    `outcome(t, attempt)` draws the attempt's fate from the seeded
    schedule; `fetch` delegates to the inner backend and NaN-poisons the
    distance payload when the schedule says 'corrupt' — exercising the
    full detect-and-degrade path instead of just flagging the request."""

    def __init__(self, spec: FaultSpec = FaultSpec(),
                 inner: Optional[RemoteBackend] = None):
        self.spec = spec
        self.inner = inner if inner is not None else OracleRemote(
            latency_ms=spec.latency_ms)

    def _rng(self, t: int, attempt: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence((self.spec.seed, int(t), int(attempt))))

    def outcome(self, t: int, attempt: int = 0) -> Outcome:
        s = self.spec
        if s.in_outage(t):
            return Outcome("outage", s.error_latency_ms)
        rng = self._rng(t, attempt)
        # one draw per failure mode, in fixed order, so adding a mode
        # never reshuffles the existing schedule
        u_err, u_corrupt, z = rng.random(), rng.random(), rng.normal()
        lat = s.latency_ms * (float(np.exp(s.latency_sigma * z))
                              if s.latency_sigma > 0 else 1.0)
        if s.spike_every > 0 and (t % s.spike_every) < s.spike_width:
            lat += s.spike_ms
        if u_err < s.error_rate:
            return Outcome("error", s.error_latency_ms)
        if u_corrupt < s.corrupt_rate:
            return Outcome("corrupt", lat)  # full latency paid, bad payload
        return Outcome("ok", lat)

    def fetch(self, rs: np.ndarray, k: int, t: int = 0, attempt: int = 0):
        o = self.outcome(t, attempt)
        if o.kind in ("error", "outage"):
            raise ConnectionError(
                f"remote {o.kind} on request {t} attempt {attempt}")
        ids, d2 = self.inner.fetch(rs, k, t, attempt)
        if o.kind == "corrupt":
            d2 = np.asarray(d2, np.float32).copy()
            d2[..., 0] = np.nan  # poisoned payload: callers must validate
        return ids, d2
