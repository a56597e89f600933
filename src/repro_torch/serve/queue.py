"""Online serving engine: request queue, dynamic batch former, admission
control and interleaved catalog mutation (port of `repro.serve.queue`).

Requests arrive (`repro_torch.serve.arrivals`), wait in a FIFO queue, are
coalesced into dynamic batches by a max-size / max-wait window, and are
served through any registered `CachePolicy`'s `serve_update_batch` — on
the deterministic virtual millisecond clock of the resilient tier, so
nothing sleeps and a run is replayable bit for bit.  The engine is host
code, ported line for line: its timestamps, batch partition, shed
decisions and histograms equal the reference's for the same arrivals.

The model (one device, one batch in flight — the single-server queue the
paper's edge node is):

* **queue** — arrivals append FIFO; an optional `queue_cap` sheds
  arrivals past that depth at their arrival instant (back-pressure).
* **batch former** — when the server is idle and requests are pending, a
  batch of up to `max_batch` requests dispatches as soon as (a) the queue
  holds `max_batch` requests, (b) the oldest pending request has waited
  `max_wait_ms`, or (c) no further arrival can come (drain).
  `max_wait_ms=None` disables the timeout: pure size-triggered batching,
  the fixed-window mode whose batch partition reproduces offline replay
  exactly.
* **admission control** — besides the queue cap, a `deadline_ms` sheds
  requests at formation when the batch's predicted completion (form time
  + service_ms of the pre-shed candidate size) already overruns their
  arrival-relative deadline.
* **service** — a formed batch of b requests occupies the server for
  `ServiceModel.service_ms(b)` virtual ms (affine: base + per_request *
  b).  The measured wall time of the policy step is reported beside it
  (`p50_step_s`), with the card synchronised before every clock read, as
  is the wall time of the mutations (`mutation_s`).
* **mutation** — churn events (`trace.rolling_catalog_events` shape:
  (step, insert_ids, remove_ids), keyed by trace position) apply between
  formed batches through the policy's `add_objects` / `remove_objects`,
  the `churn.replay_with_churn` convention: an event fires before the
  batch containing request `step`; events past the last dispatch drain at
  the end.
* **answer-cache fast path** — with the answer tier on, a request whose
  answer is memoized (`peek`, which counts nothing) completes at arrival
  + `hit_ms`; only its deferred learning update queues, so the batch
  partition is unchanged.  The engine also drives the tier's idle-unload
  clock (`tick`).

Offline equivalence: with `BatchFormerConfig(max_batch=B,
max_wait_ms=None)`, no admission control and no mutation, dispatch order
is FIFO in size-B chunks — `make_replay_batched`'s partition — so an AÇAI
policy's per-request gain and final (y, x) equal the offline replay's bit
for bit, whatever the arrival process.  The batches reach the policy on
the host, so the answer tier hashes them without a read-back.
"""

from __future__ import annotations

import dataclasses
import time as _time
from collections import deque
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.policy import StepMetrics, shed_only_metrics
from repro_torch.serve.arrivals import make_source

#: shed reasons booked into per-request records
SHED_QUEUE_FULL = "queue_full"
SHED_DEADLINE = "deadline"


@dataclasses.dataclass(frozen=True)
class BatchFormerConfig:
    """Dynamic batch window: dispatch at `max_batch` pending requests or
    when the oldest has waited `max_wait_ms`, whichever first.
    `max_wait_ms=None` = pure size trigger (the fixed-window mode)."""

    max_batch: int = 8
    max_wait_ms: Optional[float] = 5.0

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1: {self.max_batch}")
        if self.max_wait_ms is not None and self.max_wait_ms < 0:
            raise ValueError(
                f"max_wait_ms must be >= 0 or None: {self.max_wait_ms}")


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Admission control: `queue_cap` sheds arrivals past that queue
    depth; `deadline_ms` sheds requests at batch formation when the
    predicted completion already overruns arrival + deadline.  Both
    default off (admit everything — the fixed-window pin's regime)."""

    queue_cap: Optional[int] = None
    deadline_ms: Optional[float] = None

    def __post_init__(self):
        if self.queue_cap is not None and self.queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1: {self.queue_cap}")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be > 0: {self.deadline_ms}")


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    """Virtual service time of one batched step: affine in batch size (a
    fixed dispatch overhead plus per-request scan work — the measured shape
    of the batched pipeline).  Deterministic by construction so latency
    curves replay bit for bit.  The defaults are the reference's (2.0 ms +
    0.25 ms a request); `fit` calibrates the two constants to measured
    steps when absolute numbers matter."""

    base_ms: float = 2.0
    per_request_ms: float = 0.25

    def __post_init__(self):
        if self.base_ms < 0 or self.per_request_ms < 0:
            raise ValueError(
                f"service model needs nonnegative costs: "
                f"({self.base_ms}, {self.per_request_ms})")
        if self.base_ms == 0 and self.per_request_ms == 0:
            raise ValueError("service model must take nonzero time "
                             "(a 0-ms server never queues)")

    def service_ms(self, batch: int) -> float:
        return self.base_ms + self.per_request_ms * batch

    @classmethod
    def fit(cls, step_ms: dict) -> "ServiceModel":
        """The affine model through measured step times {batch: ms} (least
        squares over two or more batch sizes, clamped at 0)."""
        b = np.array(sorted(step_ms), np.float64)
        t = np.array([step_ms[k] for k in sorted(step_ms)], np.float64)
        if len(b) < 2:
            raise ValueError("ServiceModel.fit needs step times at two or more "
                             "batch sizes")
        per, base = np.polyfit(b, t, 1)
        return cls(base_ms=float(max(base, 0.0)), per_request_ms=float(max(per, 0.0)))

    def capacity_rps(self, max_batch: int) -> float:
        """Saturation throughput at full batches (requests/second) —
        the natural unit for offered-load sweeps."""
        return 1e3 * max_batch / self.service_ms(max_batch)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Pending(NamedTuple):
    rid: int
    arrival_ms: float


class RequestRecord(NamedTuple):
    """What one request experienced end to end (virtual time)."""

    rid: int
    arrival_ms: float
    form_ms: float      # batch-formation instant (= shed instant if shed)
    done_ms: float      # completion (= form_ms if shed)
    batch: int          # formed batch size (0 if shed)
    shed_reason: str    # '' | 'queue_full' | 'deadline'
    # answer-cache fast path: a hit's answer completes
    # at arrival + hit_ms without entering the batch former; what still
    # queues is only the deferred policy-learning update (so the batch
    # partition — and with it the fixed-window bitwise pin — is
    # unchanged).  `user_done_ms` is the user-visible completion: the
    # fast-path instant for hits, `done_ms` otherwise (0.0 = not set,
    # resolved at assembly).  A shed fast-path hit still answered at
    # arrival — the shed books the lost learning, not the lost answer.
    answer_hit: int = 0
    user_done_ms: float = 0.0

    @property
    def shed(self) -> bool:
        return bool(self.shed_reason)


def _device_sync(policy):
    """A callable that synchronises the card the policy serves on (a no-op
    for a policy on the host), so wall clocks read the work, not its
    enqueue."""
    inner = getattr(policy, "inner", policy)
    dev = getattr(getattr(inner, "cache", None), "device", None)
    if dev is None or dev.type != "cuda":
        return lambda: None
    return lambda: torch.cuda.synchronize(dev)


class OnlineServingEngine:
    """Drive a `CachePolicy` through an arrival process on the virtual
    clock.  One `run(...)` consumes a request trace plus an arrival
    description and returns the full latency/goodput story.

    The policy only needs the batched step contract
    (`serve_update_batch(rs, ts=None) -> StepMetrics`), so every
    registered policy — AÇAI over any index backend, every baseline,
    resilient wrappers — serves through the same queue unchanged."""

    def __init__(self, policy,
                 former: BatchFormerConfig = BatchFormerConfig(),
                 admission: AdmissionConfig = AdmissionConfig(),
                 service: ServiceModel = ServiceModel()):
        self.policy = policy
        self.former = former
        self.admission = admission
        self.service = service

    # -- simulation --------------------------------------------------------

    def run(self, reqs, arrivals, *, catalog=None,
            events: Sequence = (), slo_ms: Optional[float] = None) -> dict:
        """Serve `reqs` (T, d) with arrival schedule `arrivals` (an
        `ArrivalSpec`, a nondecreasing times array, or a ready source).

        `events` is a churn schedule ([(step, insert_ids, remove_ids)],
        trace-position keyed) applied between batches; insert events read
        their embeddings from `catalog` (the full object universe —
        required when any event inserts).  `slo_ms` sets the goodput
        target (completion within arrival + slo_ms; shed = never good).

        Returns a dict of per-request arrays in trace order (gain, cost,
        served_local, shed, arrival/form/done timestamps, queue/service/
        total latency) plus aggregate latency percentiles, goodput,
        shed share, the batch-size histogram, per-request `StepMetrics`,
        and wall p50 of the policy step.
        """
        reqs = np.asarray(reqs)
        t = reqs.shape[0]
        source = make_source(arrivals, t)
        pending_events = sorted(events, key=lambda ev: ev[0])
        if any(len(ev[1]) for ev in pending_events) and catalog is None:
            raise ValueError("insert events need the full `catalog` "
                             "universe to read embeddings from")

        queue: deque[_Pending] = deque()
        records: dict[int, RequestRecord] = {}
        batch_metrics: List[tuple[List[int], StepMetrics]] = []
        step_walls: List[float] = []
        batch_sizes: List[int] = []
        now, busy_until = 0.0, 0.0
        max_depth, ev_i, mutation_s = 0, 0, 0.0
        mb, mw = self.former.max_batch, self.former.max_wait_ms
        cap, deadline = self.admission.queue_cap, self.admission.deadline_ms
        # answer-cache fast path: peek — non-counting, so
        # policy-step hit statistics stay replay-consistent — at arrival;
        # a hit's answer completes at arrival + hit_ms and only the
        # deferred learning update queues on (batch partition unchanged)
        ac = getattr(self.policy, "answer_cache", None)
        sync = _device_sync(self.policy)
        hit_ms = ac.spec.hit_ms if ac is not None else 0.0
        fast: dict[int, float] = {}  # rid -> user-visible completion

        def admit(up_to: float) -> None:
            nonlocal max_depth
            while True:
                nxt = source.peek()
                if nxt is None or nxt > up_to:
                    return
                at, rid = source.pop()
                if ac is not None and ac.cache.peek(reqs[rid]):
                    fast[rid] = at + hit_ms
                if cap is not None and len(queue) >= cap:
                    records[rid] = RequestRecord(rid, at, at, at, 0,
                                                 SHED_QUEUE_FULL,
                                                 int(rid in fast),
                                                 fast.get(rid, 0.0))
                    source.on_complete(rid, at)
                    continue
                queue.append(_Pending(rid, at))
                max_depth = max(max_depth, len(queue))

        def apply_events(before_pos: int) -> None:
            nonlocal ev_i, mutation_s
            while (ev_i < len(pending_events)
                   and pending_events[ev_i][0] < before_pos):
                _, ins, rem = pending_events[ev_i]
                sync()
                t0 = _time.perf_counter()
                if len(ins):
                    self.policy.add_objects(catalog[np.asarray(ins)])
                if len(rem):
                    self.policy.remove_objects(rem)
                sync()
                mutation_s += _time.perf_counter() - t0
                ev_i += 1

        while source.peek() is not None or queue:
            admit(now)
            if ac is not None:
                ac.tick(now)  # the idle-unload clock
            if busy_until <= now and queue:
                full = len(queue) >= mb
                # NB: compare against the *same float expression* the
                # clock-advance horizon computes (arrival + mw), not the
                # rearranged `now - arrival >= mw`: (a+mw)-a can round
                # below mw, which would leave the timer eternally
                # "almost expired" and the loop spinning in place
                timed_out = (mw is not None
                             and now >= queue[0].arrival_ms + mw)
                drained = source.peek() is None
                if full or timed_out or drained:
                    taken = [queue.popleft()
                             for _ in range(min(mb, len(queue)))]
                    kept = taken
                    if deadline is not None:
                        est_done = now + self.service.service_ms(len(taken))
                        kept = []
                        for q in taken:
                            if est_done > q.arrival_ms + deadline:
                                records[q.rid] = RequestRecord(
                                    q.rid, q.arrival_ms, now, now, 0,
                                    SHED_DEADLINE, int(q.rid in fast),
                                    fast.get(q.rid, 0.0))
                                source.on_complete(q.rid, now)
                            else:
                                kept.append(q)
                    if kept:
                        b = len(kept)
                        # churn events fire before the batch containing
                        # their trace position (replay_with_churn rule)
                        apply_events(max(q.rid for q in kept) + 1)
                        sync()
                        t0 = _time.perf_counter()
                        m = self.policy.serve_update_batch(
                            reqs[[q.rid for q in kept]], None)
                        sync()
                        step_walls.append(_time.perf_counter() - t0)
                        done = now + self.service.service_ms(b)
                        busy_until = done
                        batch_sizes.append(b)
                        batch_metrics.append(([q.rid for q in kept], m))
                        for q in kept:
                            records[q.rid] = RequestRecord(
                                q.rid, q.arrival_ms, now, done, b, "",
                                int(q.rid in fast), fast.get(q.rid, 0.0))
                            source.on_complete(q.rid, done)
                    continue  # re-evaluate triggers at the same instant
            # advance the clock to the next actionable event: the next
            # arrival, and either the server-free instant (a window timer
            # that expires while the server is busy cannot dispatch any
            # earlier than busy_until, so it is not an event) or — idle —
            # the oldest request's window expiry (strictly future here:
            # an expired timer with an idle server dispatched above)
            horizon = []
            nxt = source.peek()
            if nxt is not None:
                horizon.append(nxt)
            if busy_until > now:
                horizon.append(busy_until)
            elif queue and mw is not None:
                horizon.append(queue[0].arrival_ms + mw)
            if not horizon:
                # queue nonempty, size trigger unmet, no timer, server
                # idle, source drained: the drain trigger fires next pass
                continue
            now = max(now, min(horizon))
        # drain every remaining churn event (the replay_with_churn rule:
        # the catalog always ends in the schedule's final state, and
        # events_applied == len(events) unconditionally)
        apply_events(float("inf"))
        return self._assemble(records, batch_metrics, batch_sizes,
                              step_walls, slo_ms, mutation_s, ev_i,
                              max_depth)

    # -- result assembly ---------------------------------------------------

    def _assemble(self, records, batch_metrics, batch_sizes, step_walls,
                  slo_ms, mutation_s, events_applied, max_depth) -> dict:
        rids = sorted(records)
        n = len(rids)
        assert rids == list(range(n)), (
            f"request ids not contiguous: {n} records over range "
            f"{rids[:3]}..{rids[-3:] if n >= 3 else rids}")
        recs = [records[r] for r in rids]
        per_req = tree_rows_to_metrics(n, batch_metrics, recs)
        arrival = np.array([r.arrival_ms for r in recs])
        form = np.array([r.form_ms for r in recs])
        done = np.array([r.done_ms for r in recs])
        shed = np.array([r.shed for r in recs], bool)
        served = ~shed
        latency = done - arrival
        queue_ms = form - arrival
        service_ms = done - form
        sizes, counts = (np.unique(batch_sizes, return_counts=True)
                         if batch_sizes else (np.array([]), np.array([])))

        def pct(a, q):
            return float(np.percentile(a, q)) if len(a) else 0.0

        lat_served = latency[served]
        res = {
            "gain": per_req.gain_int.numpy().astype(np.float64),
            "cost": per_req.cost.numpy().astype(np.float64),
            "served_local": per_req.served_local.numpy(),
            "hit": per_req.served_local.numpy() > 0,
            "occupancy": per_req.occupancy.numpy().astype(np.float64),
            "metrics": per_req,
            "arrival_ms": arrival, "form_ms": form, "done_ms": done,
            "queue_ms": queue_ms, "service_ms": service_ms,
            "latency_ms": latency,
            "shed": shed,
            "shed_reasons": [r.shed_reason for r in recs],
            "requests": n,
            "served": int(served.sum()),
            "shed_total": int(shed.sum()),
            "shed_share": float(shed.mean()) if n else 0.0,
            "p50_ms": pct(lat_served, 50),
            "p99_ms": pct(lat_served, 99),
            "p999_ms": pct(lat_served, 99.9),
            "queue_p50_ms": pct(queue_ms[served], 50),
            "queue_p99_ms": pct(queue_ms[served], 99),
            "service_p50_ms": pct(service_ms[served], 50),
            "batch_hist": {int(s): int(c) for s, c in zip(sizes, counts)},
            "mean_batch": float(np.mean(batch_sizes)) if batch_sizes else 0.0,
            "batches": len(batch_sizes),
            "max_queue_depth": max_depth,
            "events_applied": events_applied,
            "mutation_s": mutation_s,
            "p50_step_s": (float(np.percentile(step_walls, 50))
                           if step_walls else 0.0),
        }
        # answer-cache fast-path decomposition: hits'
        # user-visible completion is the arrival-time fast path, not the
        # learn-batch completion; the legacy latency fields above keep
        # their (learn-path) meaning so cache-off results are unchanged.
        ahit = np.array([bool(r.answer_hit) for r in recs], bool)
        user_done = np.where(
            ahit, np.array([r.user_done_ms for r in recs]), done)
        user_latency = user_done - arrival
        answered = served | ahit  # a shed hit was still answered
        res.update({
            "answer_hit": ahit,
            "answer_hits": int(ahit.sum()),
            "answer_hit_rate": float(ahit.mean()) if n else 0.0,
            "user_latency_ms": user_latency,
            "p50_user_ms": pct(user_latency[answered], 50),
            "p99_user_ms": pct(user_latency[answered], 99),
            "p50_hit_ms": pct(user_latency[ahit], 50),
            "p50_miss_ms": pct(latency[served & ~ahit], 50),
        })
        if slo_ms is not None:
            good = served & (latency <= slo_ms)
            res["slo_ms"] = float(slo_ms)
            res["goodput_slo"] = float(good.mean()) if n else 0.0
        return res


def _host_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def tree_rows_to_metrics(n: int, batch_metrics, recs) -> StepMetrics:
    """Scatter per-batch StepMetrics back to trace order and book the
    engine's shed rows (`shed_only_metrics`) into the same counters, so
    one (n,)-long StepMetrics (CPU tensors) tells the whole story: policy
    outcomes on served rows, shed=1 zero-gain rows on admission-control
    victims.  Each batch's fields are read back here, after the run, not
    between steps."""
    base = shed_only_metrics(n)
    cols = {f: getattr(base, f).numpy().copy() for f in StepMetrics._fields}
    for rid, rec in enumerate(recs):
        if not rec.shed:
            cols["shed"][rid] = 0
    for rids, m in batch_metrics:
        for f in StepMetrics._fields:
            v = _host_np(getattr(m, f))
            # 0-d guard: a StepMetrics field left at its int default comes
            # through as a scalar — broadcast, don't index
            if v.ndim:
                cols[f][rids] = v[:len(rids)]
            else:
                cols[f][rids] = v
    return StepMetrics(**{f: torch.from_numpy(c) for f, c in cols.items()})


def fixed_window_engine(policy, batch: int,
                        service: ServiceModel = ServiceModel()
                        ) -> OnlineServingEngine:
    """The offline-equivalent configuration (the drift pin): pure
    size-triggered batches of exactly `batch`, no admission control —
    FIFO dispatch in size-`batch` chunks, the same partition
    `make_replay_batched` scans.  With T divisible by `batch` the drain
    trigger never forms a partial batch."""
    return OnlineServingEngine(
        policy,
        former=BatchFormerConfig(max_batch=batch, max_wait_ms=None),
        admission=AdmissionConfig(),
        service=service)


def serve_trace_online(pol, reqs, arrivals, *,
                       former: BatchFormerConfig = BatchFormerConfig(),
                       admission: AdmissionConfig = AdmissionConfig(),
                       service: ServiceModel = ServiceModel(),
                       catalog=None, events: Sequence = (),
                       slo_ms: Optional[float] = None) -> dict:
    """One-call online replay — the serving twin of
    `policy_api.replay_trace`: build the engine, run the trace, return
    the result dict.  `arrivals` is an ArrivalSpec, a times array, or a
    ready source."""
    eng = OnlineServingEngine(pol, former=former, admission=admission,
                              service=service)
    return eng.run(reqs, arrivals, catalog=catalog, events=events,
                   slo_ms=slo_ms)
