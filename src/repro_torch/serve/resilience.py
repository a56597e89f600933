"""Resilient serving tier (port of `repro.serve.resilience`): deadlines,
retries, hedging, circuit breaking and the graceful-degradation ladder.

The failure model (`repro_torch.serve.remote`) only blocks remote
fetches; the approximate indexes and the embedding catalog are edge-local
metadata, so distances stay computable and the OMA ascent (Eq. 55) is
fault-independent.  On a remote failure the policy still knows which
cached object is closest, and the ladder is:

1. retry — capped exponential backoff with deterministic jitter, up to
   `RetryConfig.max_retries` extra attempts inside the deadline budget;
2. hedge — an optional second request fired `hedge_ms` into a slow
   attempt, completion = first success;
3. circuit-break — after `failure_threshold` consecutive failures the
   breaker opens and requests fail fast for `cooldown_requests`, then a
   half-open probe decides recovery (with a decision log);
4. degrade — serve the best local candidates within `degrade_ceiling x`
   the request's best healthy-serve cost, booking their true cost
   (`degraded` counter); the OMA state keeps ascending and the physical
   cache `x` freezes only while the batch is fully failed;
5. shed — only when nothing local is inside the ceiling (`shed`).

Everything above the degraded step is host code on a virtual clock fed by
the remote backend's deterministic latency schedule, ported line for
line: `simulate_request` is a pure function of `(remote, t, config)`
modulo breaker state, so its reports, the counters and the breaker's log
equal the reference's for the same `FaultSpec`.  The degraded step
(`make_degraded_step`) runs on the cache's device from the port's
batched-step pieces.  A batch whose every request succeeded takes the
cache's ordinary step, so a null fault schedule leaves the serving path
bitwise identical to the plain replay.

Randomness: the reference splits the state key on every step, the fully
failed batch whose `x` freezes included.  The degraded step draws (or
takes, `u=`) one step's rounding uniforms in every case too, so the steps
after it draw what they would have drawn.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import gain as gain_lib
from repro_torch.core import oma as oma_lib
from repro_torch.core import policy as acai
from repro_torch.core import rounding as rounding_lib
from repro_torch.core.policy import StepMetrics, first_row
from repro_torch.kernels.ref import smallest_k
from repro_torch.serve.remote import (FaultSpec, FaultyRemote,  # noqa: F401
                                      OracleRemote, RemoteBackend, payload_ok)
from repro_torch.train.fault import StragglerMonitor

#: schedule index of an attempt's hedge twin — far outside any plausible
#: retry count, so hedge draws never collide with retry draws
HEDGE_ATTEMPT_OFFSET = 1 << 20


@dataclasses.dataclass(frozen=True)
class RetryConfig:
    """Per-attempt timeout + capped exponential backoff with jitter."""

    max_retries: int = 2            # extra attempts after the first
    backoff_ms: float = 10.0        # base delay before retry #1
    backoff_cap_ms: float = 100.0   # exponential growth cap
    jitter: float = 0.1             # uniform multiplicative jitter in [0, j]
    attempt_timeout_ms: Optional[float] = 100.0  # None = wait forever


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Circuit-breaker thresholds (request-count based: the serving loop
    has no wall clock, cooldown is measured in request indices)."""

    failure_threshold: int = 8      # consecutive failures before opening
    cooldown_requests: int = 64     # open duration before half-open
    half_open_probes: int = 1       # probes allowed through half-open


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Everything the resilient serving path needs, in one knob."""

    deadline_ms: Optional[float] = 250.0  # per-request budget (None = off)
    retry: RetryConfig = dataclasses.field(default_factory=RetryConfig)
    hedge_ms: Optional[float] = None      # fire a hedge this far into an
    #                                       attempt (None = no hedging)
    breaker: BreakerConfig = dataclasses.field(default_factory=BreakerConfig)
    # degraded serve: local candidates within ceiling x the request's best
    # healthy-serve cost (nearest dissimilarity + c_f) are eligible; shed
    # past it (scale-free — see degraded_serve)
    degrade_ceiling: float = 2.0
    slow_fetch_factor: float = 3.0  # StragglerMonitor threshold on fetches
    seed: int = 0                   # backoff-jitter stream

    def __post_init__(self):
        if self.degrade_ceiling <= 0:
            raise ValueError(
                f"degrade_ceiling must be > 0: {self.degrade_ceiling}")


class RequestReport(NamedTuple):
    """What one request experienced at the remote tier (virtual time)."""

    ok: bool
    retries: int          # attempts beyond the first
    hedged: bool          # a hedge request fired
    deadline_miss: bool   # the budget was exceeded
    latency_ms: float     # virtual completion time
    failure_kind: str     # '' | 'error' | 'corrupt' | 'outage' |
    #                       'timeout' | 'deadline' | 'breaker_open'
    fast_failed: bool     # breaker open: not even attempted


class CircuitBreaker:
    """closed -> open -> half-open state machine with a decision log.

    `allow(t)` gates request `t` (False = fail fast), `record(t, ok)`
    feeds the outcome back.  Transitions are appended to `log` as
    `{"t", "from", "to", "reason"}` dicts."""

    def __init__(self, cfg: BreakerConfig = BreakerConfig()):
        self.cfg = cfg
        self.state = "closed"
        self.failures = 0           # consecutive, while closed
        self.opened_at = -1
        self.probes_left = 0
        self.log: List[dict] = []

    def _to(self, state: str, t: int, reason: str) -> None:
        self.log.append({"t": int(t), "from": self.state, "to": state,
                         "reason": reason})
        self.state = state

    def allow(self, t: int) -> bool:
        if self.state == "open":
            if t - self.opened_at >= self.cfg.cooldown_requests:
                self._to("half_open", t, "cooldown elapsed")
                self.probes_left = self.cfg.half_open_probes
            else:
                return False
        if self.state == "half_open":
            if self.probes_left <= 0:
                return False
            self.probes_left -= 1
        return True

    def record(self, t: int, ok: bool) -> None:
        if ok:
            if self.state == "half_open":
                self._to("closed", t, "probe succeeded")
            self.failures = 0
            return
        if self.state == "half_open":
            self.opened_at = t
            self._to("open", t, "probe failed")
        elif self.state == "closed":
            self.failures += 1
            if self.failures >= self.cfg.failure_threshold:
                self.opened_at = t
                self._to("open", t,
                         f"{self.failures} consecutive failures")

    @property
    def transitions(self) -> int:
        return len(self.log)


def _one_attempt(remote: RemoteBackend, t: int, attempt: int,
                 rc: RetryConfig) -> Tuple[bool, float, str]:
    """(success, virtual latency, failure kind) of a single attempt."""
    o = remote.outcome(t, attempt)
    tmo = rc.attempt_timeout_ms
    if o.kind == "ok":
        if tmo is not None and o.latency_ms > tmo:
            return False, tmo, "timeout"   # cancelled at the timeout
        return True, o.latency_ms, ""
    lat = o.latency_ms if tmo is None else min(o.latency_ms, tmo)
    return False, lat, o.kind


def _attempt_with_hedge(remote: RemoteBackend, t: int, attempt: int,
                        cfg: ResilienceConfig) -> Tuple[bool, float, str, bool]:
    """One attempt plus its optional hedge twin; completion = first
    success (min over the two virtual finish times)."""
    rc = cfg.retry
    ok1, lat1, kind1 = _one_attempt(remote, t, attempt, rc)
    if cfg.hedge_ms is None or lat1 <= cfg.hedge_ms:
        return ok1, lat1, kind1, False
    ok2, lat2, kind2 = _one_attempt(
        remote, t, attempt + HEDGE_ATTEMPT_OFFSET, rc)
    done2 = cfg.hedge_ms + lat2
    if ok1 and ok2:
        return True, min(lat1, done2), "", True
    if ok1:
        return True, lat1, "", True
    if ok2:
        return True, done2, "", True
    return False, max(lat1, done2), kind1, True


def _backoff_ms(rc: RetryConfig, seed: int, t: int, attempt: int) -> float:
    base = min(rc.backoff_ms * (2.0 ** attempt), rc.backoff_cap_ms)
    if rc.jitter <= 0:
        return base
    u = np.random.default_rng(
        np.random.SeedSequence((seed, int(t), int(attempt), 0xB0FF))).random()
    return base * (1.0 + rc.jitter * u)


def simulate_request(remote: RemoteBackend, t: int, cfg: ResilienceConfig,
                     breaker: Optional[CircuitBreaker] = None
                     ) -> RequestReport:
    """Run one request's remote interaction on the virtual clock.

    Pure given (remote schedule, t, cfg) modulo breaker state.  A success
    that lands past the deadline is a failure (the user is gone) and books
    a deadline miss."""
    if breaker is not None and not breaker.allow(t):
        return RequestReport(False, 0, False, False, 0.0, "breaker_open",
                             True)
    rc = cfg.retry
    now, retries, hedged, kind, ok = 0.0, 0, False, "", False
    attempt = 0
    while True:
        ok_a, lat_a, kind_a, h = _attempt_with_hedge(remote, t, attempt, cfg)
        hedged = hedged or h
        now += lat_a
        if ok_a:
            ok = True
            break
        kind = kind_a
        if attempt >= rc.max_retries:
            break
        if cfg.deadline_ms is not None and now >= cfg.deadline_ms:
            break  # budget exhausted: no point starting another attempt
        now += _backoff_ms(rc, cfg.seed, t, attempt)
        if cfg.deadline_ms is not None and now >= cfg.deadline_ms:
            break
        attempt += 1
        retries += 1
    miss = cfg.deadline_ms is not None and now > cfg.deadline_ms
    if ok and miss:
        ok, kind = False, "deadline"  # a late answer is a failed answer
    if breaker is not None:
        breaker.record(t, ok)
    return RequestReport(ok, retries, hedged, miss, now, kind, False)


# ---------------------------------------------------------------------------
# Session bookkeeping shared by the AÇAI and baseline resilient paths
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ResilienceCounters:
    requests: int = 0
    remote_failures: int = 0
    retries: int = 0
    deadline_misses: int = 0
    degraded: int = 0
    shed: int = 0
    hedges: int = 0
    fast_fails: int = 0
    slow_fetches: int = 0   # flagged by the StragglerMonitor

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class RemoteSession:
    """Per-policy resilience state: the remote backend, its circuit
    breaker, the slow-fetch monitor, cumulative counters and every
    request's report (latency percentiles read them)."""

    def __init__(self, remote: Optional[RemoteBackend] = None,
                 cfg: Optional[ResilienceConfig] = None):
        self.remote = remote if remote is not None else OracleRemote()
        self.cfg = cfg if cfg is not None else ResilienceConfig()
        self.breaker = CircuitBreaker(self.cfg.breaker)
        # the straggler detector flags fetches slower than
        # slow_fetch_factor x the running median
        self.monitor = StragglerMonitor(
            threshold=self.cfg.slow_fetch_factor, window=64, quiet=True)
        self.counters = ResilienceCounters()
        self.reports: List[RequestReport] = []
        self.t = 0  # request counter = fault-schedule index

    def simulate_batch(self, b: int) -> List[RequestReport]:
        reps = [simulate_request(self.remote, t, self.cfg, self.breaker)
                for t in range(self.t, self.t + b)]
        c = self.counters
        for off, r in enumerate(reps):
            c.requests += 1
            c.retries += r.retries
            c.remote_failures += int(not r.ok)
            c.deadline_misses += int(r.deadline_miss)
            c.hedges += int(r.hedged)
            c.fast_fails += int(r.fast_failed)
            # only completed fetches feed the straggler monitor (failures
            # are counted above, not "slow")
            if r.ok and self.monitor.record(
                    self.t + off, r.latency_ms / 1e3):
                c.slow_fetches += 1
        self.t += b
        self.reports.extend(reps)
        return reps

    def latency_percentiles(self) -> dict:
        lats = [r.latency_ms for r in self.reports if not r.fast_failed]
        if not lats:
            return {"p50_ms": 0.0, "p99_ms": 0.0}
        return {"p50_ms": float(np.percentile(lats, 50)),
                "p99_ms": float(np.percentile(lats, 99))}


def _report_columns(reps) -> Tuple[np.ndarray, torch.Tensor, torch.Tensor]:
    """(ok (B,) bool numpy, retries (B,), deadline misses (B,)); the two
    counters as int32 CPU tensors, booked on the host where the schedule
    runs."""
    ok = np.array([r.ok for r in reps], bool)
    retries = torch.tensor([r.retries for r in reps], dtype=torch.int32)
    misses = torch.tensor([int(r.deadline_miss) for r in reps], dtype=torch.int32)
    return ok, retries, misses


# ---------------------------------------------------------------------------
# AÇAI degraded serving
# ---------------------------------------------------------------------------

def degraded_serve_batch(d: torch.Tensor, x_cand: torch.Tensor, k: int, c_f,
                         ceiling: float):
    """Local-only serve of failed requests: per row of the (B, C) slab, up
    to k cached candidates inside the cost ceiling, true dissimilarity
    costs booked.

    A candidate is eligible when its dissimilarity is within `ceiling x`
    the request's best healthy-serve cost (nearest-candidate dissimilarity
    + c_f), a bound relative to the healthy alternative and so the same on
    every catalog's scale.

    Returns (gain, cost, n_served, shed), each (B,).  Gain pairs the j-th
    cheapest served object against the j-th empty-cache answer slot
    (d_j + c_f), clamped at 0, the reference the healthy serve's gain
    uses."""
    inf = torch.full((), float("inf"), dtype=d.dtype, device=d.device)
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    best = torch.min(d, dim=1, keepdim=True).values
    elig = (x_cand > 0.5) & (d <= ceiling * (best + c_f))
    d_served = smallest_k(torch.where(elig, d, inf), k)[0]   # +inf unserved
    got = torch.isfinite(d_served)
    empty_slots = smallest_k(d, k)[0] + c_f                  # empty-cache answer
    gain = torch.sum(torch.where(got, torch.clamp_min(empty_slots - d_served, 0.0),
                                 zero), dim=1)
    cost = torch.sum(torch.where(got, d_served, zero), dim=1)
    n_served = torch.sum(got.to(torch.int32), dim=1, dtype=torch.int32)
    return gain, cost, n_served, n_served == 0


def degraded_serve(d: torch.Tensor, x_cand: torch.Tensor, k: int, c_f,
                   ceiling: float):
    """`degraded_serve_batch` of one request's (C,) slab: scalars."""
    return tuple(t[0] for t in degraded_serve_batch(d[None], x_cand[None], k, c_f,
                                                   ceiling))


def make_degraded_step(cfg: acai.AcaiConfig, batch: int, ceiling: float,
                       eta_scale: float | None = None) -> Callable:
    """Mini-batch step for partially or fully failed batches: (state, ids,
    d, valid, ok (B,) host bools, alive, u=None) -> (state', StepMetrics
    (B,)).

    The OMA side is `apply_candidates_batched`'s: the subgradient needs
    only local distances, so y ascends on every request, failed or not.
    The serving outcome of failed rows is the degradation ladder's.  The
    physical cache `x` freezes when the whole batch failed (a fetch needs
    the remote tier); with any success in the batch, rounding proceeds.
    `u` holds the step's N rounding uniforms; they are drawn (or taken)
    whether or not `x` freezes, as the reference splits its key on every
    step.  `alive` (N,) bool keeps y = 0 on dead rows (None: all live)."""
    cfg_up = acai.scaled_config(cfg, batch, eta_scale)

    def step(state: acai.CacheState, ids, d, valid, ok, alive, u=None):
        n = state.y.shape[0]
        dev = state.y.device
        ok_np = np.asarray(ok, bool)
        ids_c = torch.clamp_max(ids, n - 1)
        zero = torch.zeros((), dtype=state.y.dtype, device=dev)
        x_cand = torch.where(valid, state.x[ids_c], zero)
        y_cand = torch.where(valid, state.y[ids_c], zero)

        served = gain_lib.serve_batch(d, x_cand, cfg.k, cfg.c_f)
        deg_gain, deg_cost, deg_served, deg_shed = degraded_serve_batch(
            d, x_cand, cfg.k, cfg.c_f, ceiling)
        gain_frac, g_cand = gain_lib.gain_and_subgradient_batch(d, y_cand, cfg.k, cfg.c_f)

        g_full = acai.scatter_rows_sum(n, ids_c, g_cand / batch, valid)
        y_new = oma_lib.oma_update(state.y, g_full, cfg.h, cfg_up.oma)
        if alive is not None:
            y_new = torch.where(alive, y_new, zero)
        if u is None:
            u = acai.draw_uniforms(state)
        if ok_np.any():
            x_new = acai._round_state(cfg_up, u, y_new, state.y, state.x, state.t,
                                      width=batch)
        else:
            x_new = state.x
        moved = rounding_lib.movement(x_new, state.x)
        fetched = torch.zeros((batch,), dtype=moved.dtype, device=dev)
        fetched[-1] = moved

        ok_b = torch.from_numpy(ok_np).to(dev)
        zi = torch.zeros((batch,), dtype=torch.int32, device=dev)
        metrics = StepMetrics(
            gain_int=torch.where(ok_b, served.gain, deg_gain),
            gain_frac=gain_frac,
            cost=torch.where(ok_b, served.cost, deg_cost),
            served_local=torch.where(
                ok_b, torch.sum(served.from_cache.to(torch.int32), dim=1,
                                dtype=torch.int32), deg_served),
            fetched=fetched,
            occupancy=torch.sum(x_new).expand(batch).clone(),
            local_overflow=zi,
            degraded=(~ok_b & ~deg_shed).to(torch.int32),
            shed=(~ok_b & deg_shed).to(torch.int32),
            remote_failures=(~ok_b).to(torch.int32),
            answer_hits=zi.clone(), answer_misses=zi.clone(),
            answer_invalidations=zi.clone())
        return acai.CacheState(y_new, x_new, state.t + batch, state.gen), metrics

    return step


class AcaiResilience:
    """The AÇAI cache's resilient serving mode (built by
    `AcaiCache.attach_remote`).

    A batch whose every request succeeded takes the cache's ordinary step
    (`_serve_batch_direct`), so at fault rate 0 the resilient path equals
    the plain replay bit for bit.  A batch with failures builds its
    candidate slab with the cache's own generator (static or mutable) and
    runs `make_degraded_step` on it."""

    def __init__(self, cache, remote: Optional[RemoteBackend] = None,
                 resilience: Optional[ResilienceConfig] = None):
        self.cache = cache
        self.session = RemoteSession(remote, resilience)
        self._deg_steps: dict[int, Callable] = {}

    def serve_update_batch(self, rs: torch.Tensor, u=None, host=None) -> StepMetrics:
        """`rs` (B, d) on the cache's device; `host` its host copy when the
        caller had one (the answer tier's keys hash it)."""
        b = rs.shape[0]
        reps = self.session.simulate_batch(b)
        ok, retries, misses = _report_columns(reps)
        cache = self.cache
        if ok.all():
            m = cache._serve_batch_direct(rs, u=u, host=host)
            if retries.any() or misses.any():  # recovered retries, late ones
                m = m._replace(retries=retries, deadline_misses=misses)
            return m
        if cache.answer_cache is not None:
            cache.answer_cache.stage(host)
        if cache._mutated:
            ids, d, valid = cache._mut_fn(rs, cache.state.x)
        else:
            ids, d, valid = cache._fn_batched(rs, cache.state.x)
        step = self._deg_steps.get(b)
        if step is None:
            step = self._deg_steps[b] = make_degraded_step(
                cache.cfg, b, self.session.cfg.degrade_ceiling)
        cache.state, m = step(cache.state, ids, d, valid, ok, cache.valid, u)
        self.session.counters.degraded += int(torch.sum(m.degraded))
        self.session.counters.shed += int(torch.sum(m.shed))
        if cache.answer_cache is not None:
            m = m._replace(**cache.answer_cache.step_counters(b))
        return m._replace(retries=retries, deadline_misses=misses)


# ---------------------------------------------------------------------------
# Generic policy wrapper (AÇAI delegates; baselines get the ladder here)
# ---------------------------------------------------------------------------

class ResilientPolicy:
    """CachePolicy wrapper adding the resilient remote tier to any
    registered policy.

    AÇAI policies delegate to the cache's own resilient mode
    (`AcaiCache.attach_remote`); baseline policies split each mini-batch
    into consecutive healthy runs, served through the inner policy
    unchanged, and per-request degraded serves
    (`KeyValueCache.step_degraded`) for the failures.  Every CachePolicy
    surface passes through."""

    def __init__(self, inner, remote: Optional[RemoteBackend] = None,
                 resilience: Optional[ResilienceConfig] = None):
        self.inner = inner
        cache = getattr(inner, "cache", None)
        if cache is not None and hasattr(cache, "attach_remote"):
            self._acai = True
            self.session = cache.attach_remote(remote, resilience).session
        else:
            self._acai = False
            self.session = RemoteSession(remote, resilience)

    spec = property(lambda self: self.inner.spec)
    k = property(lambda self: self.inner.k)
    c_f = property(lambda self: self.inner.c_f)
    h = property(lambda self: self.inner.h)

    @property
    def answer_cache(self):
        return getattr(self.inner, "answer_cache", None)

    def normalized_gain(self, total_gain: float, t: int) -> float:
        return self.inner.normalized_gain(total_gain, t)

    def add_objects(self, vectors):
        return self.inner.add_objects(vectors)

    def remove_objects(self, ids) -> None:
        self.inner.remove_objects(ids)

    def refresh(self) -> None:
        self.inner.refresh()

    def compact(self):
        return self.inner.compact()

    def serve_update(self, r, t=None, u=None) -> StepMetrics:
        rs = r[None] if isinstance(r, torch.Tensor) else np.atleast_2d(np.asarray(r))
        return first_row(self.serve_update_batch(
            rs, None if t is None else np.asarray([t]), u=u))

    def serve_update_batch(self, rs, ts=None, u=None) -> StepMetrics:
        if self._acai:
            return self.inner.serve_update_batch(rs, ts, u=u)
        if u is not None:
            raise TypeError(f"{self.inner.spec.name} draws no rounding uniforms")
        return self._baseline_batch(rs, ts)

    def _baseline_batch(self, rs, ts) -> StepMetrics:
        from repro_torch.core.baselines import host_f32

        rs = np.atleast_2d(host_f32(rs))
        b = rs.shape[0]
        reps = self.session.simulate_batch(b)
        ok, retries, misses = _report_columns(reps)
        cols = {f: np.zeros(b, np.float64) for f in ("gain_int", "gain_frac", "cost")}
        icols = {f: np.zeros(b, np.int32) for f in
                 ("served_local", "fetched", "degraded", "shed")}
        occ = np.zeros(b, np.float64)
        pol = self.inner.policy
        ceiling = self.session.cfg.degrade_ceiling
        i = 0
        while i < b:
            if ok[i]:
                j = i
                while j < b and ok[j]:
                    j += 1
                sub = self.inner.serve_update_batch(
                    rs[i:j], None if ts is None else np.asarray(ts)[i:j])
                for f in cols:
                    cols[f][i:j] = getattr(sub, f).numpy()
                for f in ("served_local", "fetched"):
                    icols[f][i:j] = getattr(sub, f).numpy()
                occ[i:j] = sub.occupancy.numpy()
                i = j
            else:
                res, shed = pol.step_degraded(rs[i], ceiling=ceiling)
                cols["gain_int"][i] = cols["gain_frac"][i] = res.gain
                cols["cost"][i] = res.cost
                icols["served_local"][i] = res.served_local
                icols["degraded"][i] = int(not shed)
                icols["shed"][i] = int(shed)
                occ[i] = float(len(pol.cached_object_ids()))
                self.session.counters.degraded += int(not shed)
                self.session.counters.shed += int(shed)
                i += 1
        zi = np.zeros(b, np.int32)
        t = torch.from_numpy
        return StepMetrics(
            gain_int=t(cols["gain_int"]), gain_frac=t(cols["gain_frac"]),
            cost=t(cols["cost"]), served_local=t(icols["served_local"]),
            fetched=t(icols["fetched"]), occupancy=t(occ),
            local_overflow=t(zi.copy()), degraded=t(icols["degraded"]),
            shed=t(icols["shed"]), remote_failures=t((~ok).astype(np.int32)),
            retries=retries, deadline_misses=misses,
            answer_hits=t(zi.copy()), answer_misses=t(zi.copy()),
            answer_invalidations=t(zi.copy()))


def _np64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def replay_resilient(pol, reqs, *, batch: int = 8, uniforms=None) -> dict:
    """Drive a trace through a resilient policy and aggregate the
    resilience story: per-request metric arrays plus goodput (the share of
    requests answered, healthy or degraded), degraded and shed shares,
    virtual latency percentiles, retry / deadline / hedge totals and the
    breaker's log.  `p50_step_s` is the host clock around a step, with the
    card synchronised before each read.  `uniforms` (T / batch, N)
    optionally injects each step's rounding uniforms (AÇAI)."""
    import time as _time

    reqs = np.asarray(reqs)
    t = reqs.shape[0]
    tt = (t // batch) * batch
    if tt == 0:
        raise ValueError(f"trace of {t} requests is shorter than one "
                         f"mini-batch (batch={batch})")
    dev = getattr(getattr(getattr(pol, "inner", pol), "cache", None), "device",
                  torch.device("cpu"))
    fields = ("gain_int", "cost", "served_local", "fetched", "occupancy",
              "degraded", "shed", "remote_failures", "retries",
              "deadline_misses")
    out = {f: [] for f in fields}
    times = []
    for i, s in enumerate(range(0, tt, batch)):
        u = None if uniforms is None else uniforms[i]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = _time.perf_counter()
        m = pol.serve_update_batch(reqs[s:s + batch], None, u=u)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(_time.perf_counter() - t0)
        for f in fields:
            out[f].append(np.broadcast_to(_np64(getattr(m, f)), (batch,)))
    res = {f: np.concatenate(v) for f, v in out.items()}
    res["gain"] = res.pop("gain_int")
    res["hit"] = res["served_local"] > 0
    res["requests"] = tt
    res["p50_step_s"] = float(np.percentile(times, 50)) if times else 0.0
    ses = pol.session
    res["goodput"] = 1.0 - float(res["shed"].sum()) / tt
    res["degraded_share"] = float(res["degraded"].sum()) / tt
    res["shed_share"] = float(res["shed"].sum()) / tt
    res["counters"] = ses.counters.to_dict()
    res["breaker_transitions"] = ses.breaker.transitions
    res["breaker_log"] = list(ses.breaker.log)
    res.update(ses.latency_percentiles())
    return res
