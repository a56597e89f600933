"""The churn replay: a trace plus an insert / expire schedule, one policy
(port of `repro.core.churn`).

`replay_with_churn` drives any `CachePolicy` (or a bare `AcaiCache`)
through a request trace while a `rolling_catalog_events` schedule mutates
the catalog between mini-batch steps: inserts through `add_objects`,
expiries through `remove_objects`, with an optional refresh cadence and an
optional epoch-compaction cadence.

Refresh is two-phase when the policy has the hooks: at a due boundary the
replay calls `refresh_start()` (the shadow rebuild; the stale structures
serve the next mini-batch) and installs the shadow with `refresh_swap()`
at the next boundary, before that boundary's events.  Only the swap is
serving-visible (`refresh_stall_s`, beside the total `refresh_s`).

Compaction renumbers slab rows, so the replay keeps a trace-id -> slab-id
translation, updated from each remap `compact()` returns; before the first
compaction it is the identity, and the replay checks that the policy
assigns the trace's row ids.

Time goes into three channels: serving steps (`p50_step_s`), mutation
(`mutation_s`, split into `mutation_device_s`, the writes timed by
`repro_torch.index.base.run_device`, and `mutation_host_s`, the rest), and
refresh (`refresh_s`, `refresh_stall_s`), with compaction apart
(`compact_s`).  On the card every channel is read between
synchronisations, as `replay_trace_steps` times its steps.

At churn rate 0 the schedule is empty: the policy never leaves its static
step, and an AÇAI replay equals `make_replay_batched` on the same trace.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.policy_api import _np


def warm_size(n: int, warm: float) -> int:
    """Live-window population of a rolling_catalog trace (the rounding of
    `trace.rolling_catalog_events`)."""
    return max(int(round(warm * n)), 1)


def _initial_rows(pol) -> int:
    """Slab rows the policy was built with (the warm prefix): the span of
    the identity trace-id -> slab-id translation."""
    for obj in (pol, getattr(pol, "cache", None)):
        n = getattr(obj, "_n_slots", None)
        if n is not None:
            return int(n)
    oracle = getattr(pol, "oracle", None)
    if oracle is not None:
        return int(oracle.catalog.shape[0])
    raise TypeError(f"cannot infer the policy's initial row count for compaction id "
                    f"translation: {type(pol).__name__}")


def _cache(pol):
    """The AcaiCache behind an AÇAI policy, or the policy itself."""
    return getattr(pol, "cache", pol)


def replay_with_churn(pol, catalog: np.ndarray, reqs: np.ndarray, events: Sequence, *,
                      batch: int = 8, refresh_every: int = 0, compact_every: int = 0,
                      uniforms_fn: Callable | None = None) -> dict:
    """Replay `reqs` through `pol` while `events` mutate the catalog.

    pol: a CachePolicy or AcaiCache with `serve_update_batch`,
    `add_objects`, `remove_objects`, `refresh` (and optionally the
    two-phase `refresh_start` / `refresh_swap` and `compact`), built over
    the catalog's warm prefix.  catalog: the whole (N, d) object universe
    (inserts read their rows here).  reqs: (T, d); a tail that does not
    fill a mini-batch is not served.  events: [(step, insert_ids,
    remove_ids), ...], steps ascending; an event fires before the
    mini-batch holding request `step`, and events in the unserved tail are
    applied after the last mini-batch.  refresh_every / compact_every:
    cadences in requests (0 = never).  uniforms_fn(step, n) -> (n,)
    rounding uniforms of mini-batch `step` over a state of n rows (an AÇAI
    policy's; None: its own generator), so a test can inject the
    reference's draws.

    Returns per-request arrays (gain, cost, served_local, hit, fetched,
    occupancy) and `p50_step_s`, `mutation_s`, `mutation_host_s`,
    `mutation_device_s`, `refresh_s`, `refresh_stall_s`, `compact_s`,
    `events_applied`, `compactions`, `requests`."""
    from repro_torch.index import base

    reqs = np.asarray(reqs)
    t = reqs.shape[0]
    tt = (t // batch) * batch
    if tt == 0:
        raise ValueError(f"trace of {t} requests is shorter than one mini-batch "
                         f"(batch={batch})")
    # the card is synchronised around each timed piece of an AÇAI policy
    dev = getattr(_cache(pol), "device", torch.device("cpu"))

    def clock() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    pending = sorted(events, key=lambda ev: ev[0])
    out = {k: [] for k in ("gain", "cost", "served_local", "fetched", "occupancy")}
    times: list[float] = []
    acc = dict(mutation=0.0, mutation_dev=0.0, refresh=0.0, stall=0.0, compact=0.0)
    applied = compactions = 0
    next_refresh, next_compact = refresh_every, compact_every
    two_phase = hasattr(pol, "refresh_start") and hasattr(pol, "refresh_swap")
    swap_pending = False
    # trace id -> slab row id; the identity until the first compaction
    g2s = np.full(catalog.shape[0], -1, np.int64)
    n0 = _initial_rows(pol)
    g2s[:n0] = np.arange(n0)
    compacted = False
    ev_i = 0

    def apply_event(ins, rem) -> None:
        nonlocal applied
        t0 = clock()
        dev0 = base.device_mutation_seconds()
        if len(ins):
            ins = np.asarray(ins)
            got = np.asarray(pol.add_objects(catalog[ins]))
            if not compacted and not (got == ins).all():
                raise AssertionError(
                    f"row-id misalignment: schedule inserts {ins}, policy assigned {got} "
                    f"— was the policy built on catalog[:n_warm]?")
            g2s[ins] = got
        if len(rem):
            rem = np.asarray(rem)
            slab = g2s[rem]
            if not (slab >= 0).all():
                raise AssertionError(f"schedule removes never-inserted rows {rem[slab < 0]}")
            pol.remove_objects(slab.astype(np.int32))
            g2s[rem] = -1
        acc["mutation"] += clock() - t0
        acc["mutation_dev"] += base.device_mutation_seconds() - dev0
        applied += 1

    def swap() -> None:
        t0 = clock()
        pol.refresh_swap()
        dt = clock() - t0
        acc["refresh"] += dt
        acc["stall"] += dt

    for step_i, s in enumerate(range(0, tt, batch)):
        # (1) install a pending shadow before this boundary's events, which
        # would discard it
        if swap_pending:
            swap()
            swap_pending = False
        # (2) this boundary's churn events
        while ev_i < len(pending) and pending[ev_i][0] < s + batch:
            _, ins, rem = pending[ev_i]
            apply_event(ins, rem)
            ev_i += 1
        # (3) compaction after the events, so fresh tombstones are reclaimed
        if compact_every and s >= next_compact:
            t0 = clock()
            remap = np.asarray(pol.compact())
            acc["compact"] += clock() - t0
            live = g2s >= 0
            g2s[live] = remap[g2s[live]]
            if not (g2s[live] >= 0).all():
                raise AssertionError("compaction dropped live rows")
            compacted = True
            compactions += 1
            next_compact += compact_every
        # (4) start a shadow rebuild; the stale structures serve until the
        # swap at the next boundary (a blocking refresh stalls whole)
        if refresh_every and s >= next_refresh:
            t0 = clock()
            if two_phase:
                pol.refresh_start()
                swap_pending = True
                acc["refresh"] += clock() - t0
            else:
                pol.refresh()
                dt = clock() - t0
                acc["refresh"] += dt
                acc["stall"] += dt
            next_refresh += refresh_every
        rs = reqs[s:s + batch]
        kw = {}
        if uniforms_fn is not None:
            n_state = _cache(pol).state.y.shape[0]  # the slab's capacity
            kw["u"] = torch.as_tensor(uniforms_fn(step_i, n_state),
                                      dtype=torch.float32).to(dev)
        t0 = clock()
        m = pol.serve_update_batch(rs, **kw)
        times.append(clock() - t0)
        out["gain"].append(_np(m.gain_int, np.float64))
        out["cost"].append(_np(m.cost, np.float64))
        out["served_local"].append(_np(m.served_local))
        out["fetched"].append(_np(m.fetched))
        out["occupancy"].append(_np(m.occupancy, np.float64))
    # drain: a pending shadow is installed, then the events of the unserved
    # tail apply, so the catalog ends in the schedule's final state
    if swap_pending:
        swap()
    while ev_i < len(pending):
        _, ins, rem = pending[ev_i]
        apply_event(ins, rem)
        ev_i += 1
    res = {k: np.concatenate(v) for k, v in out.items()}
    res["hit"] = res["served_local"] > 0
    res["p50_step_s"] = float(np.percentile(times, 50)) if times else 0.0
    res["mutation_s"] = acc["mutation"]
    res["mutation_device_s"] = acc["mutation_dev"]
    res["mutation_host_s"] = max(acc["mutation"] - acc["mutation_dev"], 0.0)
    res["refresh_s"] = acc["refresh"]
    res["refresh_stall_s"] = acc["stall"]
    res["compact_s"] = acc["compact"]
    res["events_applied"] = applied
    res["compactions"] = compactions
    res["requests"] = int(tt)
    return res
