"""Synthetic datasets + request traces matching the paper's Sec. V-A setup.

A numpy copy of `repro.core.trace`: the same seed gives bitwise the same
arrays as the reference, so the port and the JAX package replay one trace.

SIFT1M and the Amazon crawl are not available offline; we generate
statistically matched stand-ins:

* `sift_like`   — N points ~ U[0,1]^d (SIFT descriptors are dense,
  roughly isotropic after whitening).  Requests follow the Independent
  Reference Model with lambda_i ∝ d_i^{-beta}, d_i = distance of object i
  from the catalog barycenter — the paper's exact construction — with beta
  calibrated so the ranked-popularity tail matches Zipf(0.9).
* `amazon_like` — Gaussian-mixture clustered embeddings (product
  categories) + a non-stationary request process: a slow random walk over
  cluster preferences (temporal drift of review traffic).
* `flash_crowd` — the SIFT-like stationary base process interrupted by
  popularity shocks: during each shock window a small random object set
  captures most of the traffic (breaking-news / viral-item bursts), then
  the base popularity resumes.  Stresses how fast a policy re-learns
  after an abrupt, transient shift.
* `adversarial` — worst-case drift for LRU-style recency heuristics: the
  catalog is sliced into well-separated regions and the request process
  jumps between *maximally distant* regions in phases, so any policy
  chasing recent requests keeps paying full misses.  This is the regime
  where OMA's no-regret guarantee (Theorem IV.1) — and nothing weaker —
  still holds.
* `rolling_catalog` — the mutable-catalog workload (DESIGN.md §10):
  the catalog itself churns.  Only a warm window is live at t = 0;
  a deterministic insert+expire stream (`rolling_catalog_events`, rate =
  `churn_rate` events per request) rolls the window forward over the
  object universe, and every request targets the *currently live* set.
  At `churn_rate = 0` this degenerates to `sift_like` over the warm
  window — the static-replay consistency anchor the churn bench pins.

Every generator returns (catalog (N,d), request embeddings (T,d),
request ids (T,)).  Requests are *for catalog points* (the k=1 exact
target exists), matching the benchmark datasets where queries are
held-out points of the same distribution — we optionally jitter the
request embedding.  For `rolling_catalog` the returned catalog is the
whole object universe (live + not-yet-inserted + expired rows); the event
schedule that says *when* each row goes live/dead is a pure function of
the same params, re-derivable via `rolling_catalog_events`.

`TraceSpec` + `build_trace` mirror the index layer's `IndexSpec` +
`build_index` (DESIGN.md §8/§9): a serializable (scenario name + kwargs)
description that the experiment harness, CLI surfaces and provenance
records all share.  Generators register via `register_trace`, so adding a
scenario is a single registration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np


def _zipf_calibrate_beta(dist_rank: np.ndarray, zipf_a: float = 0.9) -> float:
    """Pick beta so lambda ∝ d^{-beta} has a Zipf(a)-like ranked tail.

    Matching the log-log slope of the ranked popularity curve: if ranked
    distances grow ~ rank^gamma then lambda_(rank) ~ rank^(-beta*gamma); we
    want beta*gamma = a.

    Robust to tiny catalogs: the body window [n//100+1, n//2) degenerates
    below n ~ 200 (short or empty slice -> polyfit warnings / crashes), so
    the fit widens to every rank when the window is under 8 points, and a
    non-finite or non-positive slope falls back to gamma = 1 (beta =
    zipf_a) instead of exploding."""
    n = dist_rank.shape[0]
    if n < 2:
        return float(zipf_a)
    ranks = np.arange(1, n + 1)
    lo, hi = n // 100 + 1, n // 2  # fit the body, ignore head/tail noise
    if hi - lo < 8:  # tiny catalog: no body/tail distinction to exploit
        lo, hi = 0, n
    sel = slice(lo, hi)
    with np.errstate(all="ignore"):
        gamma = np.polyfit(np.log(ranks[sel]),
                           np.log(dist_rank[sel] + 1e-12), 1)[0]
    if not np.isfinite(gamma) or gamma <= 0:
        gamma = 1.0
    return float(zipf_a / max(gamma, 1e-3))


def _barycentric_popularity(catalog: np.ndarray, zipf_a: float) -> np.ndarray:
    """The paper's IRM construction: lambda_i ∝ d_i^{-beta}, d_i = distance
    from the catalog barycenter, beta Zipf-calibrated."""
    bary = catalog.mean(axis=0, keepdims=True)
    dist = np.linalg.norm(catalog - bary, axis=1)
    beta = _zipf_calibrate_beta(np.sort(dist), zipf_a)
    with np.errstate(all="ignore"):
        lam = (dist + 1e-9) ** (-beta)
        lam = lam / lam.sum()
    if not np.isfinite(lam).all():
        # degenerate catalogs can calibrate a huge beta and overflow the
        # power; renormalise in log space (same distribution, no overflow)
        log_lam = -beta * np.log(dist + 1e-9)
        lam = np.exp(log_lam - log_lam.max())
        lam = lam / lam.sum()
    return lam


def sift_like(
    n: int = 20000,
    d: int = 32,
    t: int = 30000,
    zipf_a: float = 0.9,
    jitter: float = 0.0,
    seed: int = 0,
):
    rng = np.random.default_rng(seed)
    catalog = rng.random((n, d), dtype=np.float32)
    lam = _barycentric_popularity(catalog, zipf_a)
    ids = rng.choice(n, size=t, p=lam)
    reqs = catalog[ids]
    if jitter > 0:
        reqs = reqs + rng.normal(0, jitter, reqs.shape).astype(np.float32)
    return catalog, reqs.astype(np.float32), ids


def amazon_like(
    n: int = 20000,
    d: int = 32,
    t: int = 30000,
    clusters: int = 50,
    drift: float = 0.05,
    seed: int = 1,
):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1.0, (clusters, d)).astype(np.float32)
    assign = rng.integers(0, clusters, n)
    catalog = centers[assign] + rng.normal(0, 0.25, (n, d)).astype(np.float32)

    # non-stationary cluster preference random walk
    logits = rng.normal(0, 1.0, clusters)
    ids = np.empty(t, dtype=np.int64)
    members = [np.nonzero(assign == c)[0] for c in range(clusters)]
    members = [m if len(m) else np.array([0]) for m in members]
    # per-cluster popularity (Zipf within cluster)
    for step in range(t):
        logits += rng.normal(0, drift, clusters)
        p = np.exp(logits - logits.max())
        p /= p.sum()
        c = rng.choice(clusters, p=p)
        m = members[c]
        w = (np.arange(len(m)) + 1.0) ** -0.9
        ids[step] = m[rng.choice(len(m), p=w / w.sum())]
    return catalog, catalog[ids].copy(), ids


def flash_crowd(
    n: int = 20000,
    d: int = 32,
    t: int = 30000,
    zipf_a: float = 0.9,
    shocks: int = 4,
    shock_len: float = 0.08,
    shock_objects: int = 20,
    shock_share: float = 0.8,
    seed: int = 7,
):
    """Stationary SIFT-like base + `shocks` popularity shocks.

    Shock windows (each `shock_len` of the trace, evenly spaced) reroute
    `shock_share` of the traffic to a fresh random set of `shock_objects`
    objects with internal Zipf(1) popularity; outside the windows the base
    IRM process is untouched, so the paper's statistical-regularity
    assumption holds piecewise but not globally."""
    rng = np.random.default_rng(seed)
    catalog = rng.random((n, d), dtype=np.float32)
    lam = _barycentric_popularity(catalog, zipf_a)
    ids = rng.choice(n, size=t, p=lam)

    width = max(int(t * shock_len), 1)
    shock_objects = min(shock_objects, n)
    starts = np.linspace(0, max(t - width, 0), shocks + 2)[1:-1].astype(int)
    w = (np.arange(shock_objects) + 1.0) ** -1.0
    w /= w.sum()
    for s in starts:
        crowd = rng.choice(n, size=shock_objects, replace=False)
        hot = rng.random(width) < shock_share
        ids[s:s + width][hot] = crowd[
            rng.choice(shock_objects, size=int(hot.sum()), p=w)]
    return catalog, catalog[ids].copy(), ids


def adversarial(
    n: int = 20000,
    d: int = 32,
    t: int = 30000,
    phases: int = 8,
    phase_zipf: float = 0.6,
    separation: float = 3.0,
    seed: int = 11,
):
    """Worst-case drift: phase p concentrates every request on the region
    farthest from phase p-1's region.

    The catalog is `phases` unit cubes of equal population, placed along a
    random direction with centers `separation` apart — well beyond the
    within-cube spread, so each region's kNN answers live entirely inside
    it.  The phase order alternates between the two extremes (0, P-1, 1,
    P-2, ...): consecutive phases are near-maximally separated in
    embedding space and a recency-driven cache is always wrong about
    where the next burst lands.  Within a phase, requests are
    Zipf(`phase_zipf`) over the region (some regularity for OMA to
    exploit *inside* the phase)."""
    rng = np.random.default_rng(seed)
    catalog = rng.random((n, d), dtype=np.float32)
    u = rng.normal(size=d).astype(np.float32)
    u /= np.linalg.norm(u) + 1e-12
    slabs = np.array_split(rng.permutation(n), phases)
    for c, slab in enumerate(slabs):
        catalog[slab] += (c * separation) * u

    # alternate extremes: 0, P-1, 1, P-2, ... — consecutive phases live at
    # opposite ends of the principal direction
    seq = []
    lo_i, hi_i = 0, phases - 1
    while lo_i <= hi_i:
        seq.append(lo_i)
        if hi_i != lo_i:
            seq.append(hi_i)
        lo_i, hi_i = lo_i + 1, hi_i - 1

    ids = np.empty(t, dtype=np.int64)
    bounds = np.linspace(0, t, len(seq) + 1).astype(int)
    for p, (a, b) in zip(seq, zip(bounds[:-1], bounds[1:])):
        slab = slabs[p]
        w = (np.arange(len(slab)) + 1.0) ** (-phase_zipf)
        w /= w.sum()
        ids[a:b] = slab[rng.choice(len(slab), size=b - a, p=w)]
    return catalog, catalog[ids].copy(), ids


def rolling_catalog_events(
    n: int = 20000,
    t: int = 30000,
    churn_rate: float = 0.02,
    warm: float = 0.5,
    **_unused,
):
    """Deterministic insert/expire schedule for `rolling_catalog`.

    A pure function of (n, t, churn_rate, warm) — no RNG — so the trace
    generator, the churn replay driver, the bench suite and the tests all
    derive the *same* schedule from the same TraceSpec params (the extra
    **kwargs swallow the generator-only params like d/zipf_a/seed, so the
    full spec param dict can be splatted in).

    The live window starts as rows [0, n0), n0 = round(warm * n).  E =
    min(round(churn_rate * t), n - n0) events are spread evenly over the
    trace; event i fires *before* request step ((i + 1) * t) // (E + 1),
    inserts row n0 + i and expires row i — a rolling window of constant
    population n0.  Returns a list of (step, insert_ids (np.int32),
    remove_ids (np.int32)) with strictly increasing steps (events landing
    on the same step are merged).
    """
    n0 = max(int(round(warm * n)), 1)
    e = min(int(round(churn_rate * t)), n - n0)
    merged: "dict[int, tuple[list, list]]" = {}
    for i in range(e):
        step = ((i + 1) * t) // (e + 1)
        ins, rem = merged.setdefault(step, ([], []))
        ins.append(n0 + i)
        rem.append(i)
    return [(step, np.asarray(ins, np.int32), np.asarray(rem, np.int32))
            for step, (ins, rem) in sorted(merged.items())]


def rolling_catalog(
    n: int = 20000,
    d: int = 32,
    t: int = 30000,
    churn_rate: float = 0.02,
    warm: float = 0.5,
    zipf_a: float = 0.9,
    seed: int = 17,
):
    """Rolling-window catalog churn: requests always target the live set.

    The object universe is SIFT-like (n points ~ U[0,1]^d) with the
    paper's barycentric IRM popularity over the *whole* universe; at any
    step only the rows the `rolling_catalog_events` schedule has made live
    can be requested (popularity renormalised over the live window per
    inter-event epoch).  Content "freshness" churn with stationary
    geometry: the embedding distribution never drifts, only membership —
    isolating the index/cache-invalidation cost from distribution shift
    (amazon_like/flash_crowd cover the latter).
    """
    rng = np.random.default_rng(seed)
    catalog = rng.random((n, d), dtype=np.float32)
    lam = _barycentric_popularity(catalog, zipf_a)
    events = rolling_catalog_events(n, t, churn_rate=churn_rate, warm=warm)
    n0 = max(int(round(warm * n)), 1)
    live = np.zeros(n, bool)
    live[:n0] = True
    ids = np.empty(t, dtype=np.int64)
    prev = 0
    for step, ins, rem in events + [(t, np.empty(0, np.int32),
                                     np.empty(0, np.int32))]:
        if step > prev:
            p = np.where(live, lam, 0.0)
            p = p / p.sum()
            ids[prev:step] = rng.choice(n, size=step - prev, p=p)
        live[ins] = True
        live[rem] = False
        prev = max(prev, step)
    return catalog, catalog[ids].copy(), ids


def ranked_popularity(ids: np.ndarray, n: int) -> np.ndarray:
    counts = np.bincount(ids, minlength=n).astype(np.float64)
    return np.sort(counts)[::-1]


# ---------------------------------------------------------------------------
# TraceSpec registry (the workload twin of repro.index.base.IndexSpec)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Serializable workload selection: scenario name + generator kwargs.

    The workload twin of `IndexSpec`/`PolicySpec` (DESIGN.md §8/§9): one
    value naming a scenario and everything needed to regenerate it, so a
    benchmark row or provenance record fully determines its trace.

    `name` must be a registered scenario (`registered_traces()`; today
    ``sift_like | amazon_like | flash_crowd | adversarial |
    rolling_catalog``).  `params` are passed verbatim to the registered
    generator, so valid keys are exactly its keyword arguments — e.g.
    ``TraceSpec("flash_crowd", {"n": 4000, "shocks": 6})``.  Common
    params: ``n`` (catalog size), ``d`` (embedding dim), ``t`` (trace
    length), ``seed``, plus per-scenario knobs (``drift``, ``shocks``,
    ``phases``, ``churn_rate`` ...).

    Round-trips through a flat dict (`to_dict` / `from_dict`) with the
    name under the ``"name"`` key, so a spec can live in benchmark grids,
    CLI flags and provenance records; `with_params` derives size-reduced
    or swept variants.

    Example::

        spec = TraceSpec("rolling_catalog", {"churn_rate": 0.05})
        catalog, reqs, ids = build_trace(spec, n=2000, t=4096)
    """

    name: str
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "params", dict(self.params))
        if "name" in self.params:
            raise ValueError("'name' is the spec field, not a param")

    def __hash__(self):
        return hash((self.name, tuple(sorted(self.params.items()))))

    def to_dict(self) -> Dict[str, Any]:
        """Flat dict form: {'name': scenario, **params}."""
        return {"name": self.name, **self.params}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TraceSpec":
        d = dict(d)
        try:
            name = d.pop("name")
        except KeyError:
            raise ValueError(f"trace spec dict needs a 'name' key: {d}")
        if name not in _TRACES:
            raise ValueError(_unknown_trace_msg(name))
        return cls(name, d)

    def with_params(self, **updates) -> "TraceSpec":
        return TraceSpec(self.name, {**self.params, **updates})


_TRACES: Dict[str, Callable] = {}


def register_trace(name: str):
    """Decorator registering `fn(**params) -> (catalog, reqs, ids)`."""

    def deco(fn: Callable) -> Callable:
        if name in _TRACES:
            raise ValueError(f"trace scenario {name!r} already registered")
        _TRACES[name] = fn
        return fn

    return deco


def registered_traces() -> Tuple[str, ...]:
    return tuple(sorted(_TRACES))


def _unknown_trace_msg(name: str) -> str:
    return (f"unknown trace scenario {name!r}; registered: "
            f"{', '.join(registered_traces())}")


def build_trace(spec, **overrides):
    """Generate the (catalog, requests, ids) a spec describes.

    Args:
      spec: a `TraceSpec`, a registered scenario name, or the flat dict
        form (``{"name": "sift_like", "n": 4000}``).
      **overrides: generator kwargs merged *over* the spec params — the
        experiment harness uses this for size reductions (n=..., t=...)
        without rewriting the spec.

    Returns:
      (catalog (N, d) float32, requests (T, d) float32, ids (T,)) — the
      object embeddings, the request stream, and each request's target
      catalog row.  Generators are deterministic in their ``seed`` param,
      so equal specs yield bitwise-equal traces.

    Raises:
      ValueError for unregistered scenario names (listing the registry).
    """
    if isinstance(spec, str):
        spec = TraceSpec(spec)
    elif isinstance(spec, Mapping):
        spec = TraceSpec.from_dict(spec)
    try:
        fn = _TRACES[spec.name]
    except KeyError:
        raise ValueError(_unknown_trace_msg(spec.name))
    return fn(**{**spec.params, **overrides})


register_trace("sift_like")(sift_like)
register_trace("amazon_like")(amazon_like)
register_trace("flash_crowd")(flash_crowd)
register_trace("adversarial")(adversarial)
register_trace("rolling_catalog")(rolling_catalog)


# Smallest sensible generator kwargs per scenario (fractions of a second
# each).  The single source of truth for the policy-conformance test
# (tests/test_policy_api.py) and the scripts/smoke.sh experiment sweep —
# a new scenario registers here once and both pick it up.
TINY_TRACE_KWARGS = {
    "sift_like": {"n": 256, "d": 16, "t": 64},
    "amazon_like": {"n": 256, "d": 16, "t": 64, "clusters": 8},
    "flash_crowd": {"n": 256, "d": 16, "t": 64, "shocks": 2,
                    "shock_objects": 8},
    "adversarial": {"n": 256, "d": 16, "t": 64, "phases": 4},
    "rolling_catalog": {"n": 256, "d": 16, "t": 64, "churn_rate": 0.1,
                        "warm": 0.5},
}
