"""Unified policy API: protocol, spec and config-driven policy registry
(port of `repro.core.policy_api`).

The paper's claims (Sec. V, Figs. 1-8) are comparative: AÇAI against the
similarity-caching baselines (SIM-LRU / CLS-LRU / RND-LRU / QCACHE / LRU)
across traces with and without statistical regularity.  This module makes
that comparison one surface, as the index layer's registry does one layer
down:

* `CachePolicy` — the batched step protocol every policy implements:
  `serve_update_batch(rs (B, d), ts) -> StepMetrics` serves a request
  mini-batch against the current cache state and applies the policy's
  update.  `ts` are the requests' trace positions into the shared
  `ServerOracle` table (baselines read their precomputed exact kNN answers
  there); AÇAI ignores them.
* `PolicySpec` — a serializable (policy name + kwargs) description, the
  one config knob selecting a policy end to end: the experiment harness
  (`repro_torch.experiments`), `SemanticCachedLM(policy_spec=...)` and
  `launch/serve.py --policy / --policy-opt`.  Every registered policy
  accepts the paper's `augmented` serving-rule flag (a no-op for AÇAI,
  whose serving rule is the augmented one).
* `build_policy(spec, catalog, cost_model, oracle=None, index_spec=None,
  seed=0, device=None)` — the registry constructor.  AÇAI builds an
  `AcaiCache` on `device` (the card by default), optionally over an
  approximate index (`index_spec`); baselines build over the shared
  `ServerOracle` (one per trace, reused by every policy of a grid), whose
  exact scan runs on `device`, with their hit tests and serving costs
  vectorized per mini-batch on the host
  (`repro_torch.core.baselines.KeyValueCache.step_batch`).

AÇAI's `answer_cache=` fronts its index with the exact answer memo
(`repro_torch.serve.answer_cache`); the baselines reject it, as in the
reference.  `replay_trace_online` drives any policy through the online
serving engine (`repro_torch.serve.queue`).  Every policy's catalog
mutates online (`add_objects`, `remove_objects`, `refresh`, `compact`; the
churn replay is `repro_torch.core.churn`).  `mesh=` (ROADMAP A11) raises
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import time
from typing import (Any, Callable, Dict, Mapping, Optional, Protocol, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.core import baselines as B
from repro_torch.core import oma as oma_lib
from repro_torch.core import policy as acai
from repro_torch.core.costs import CostModel
from repro_torch.core.policy import StepMetrics, first_row


@runtime_checkable
class CachePolicy(Protocol):
    """Batched cache policy over a catalog of object embeddings: the one
    step contract every registered policy speaks, so harnesses
    (`replay_trace`, the experiment grids, the serving tier) never branch
    on the policy name.

    * `serve_update_batch(rs (B, d), ts (B,) | None) -> StepMetrics` —
      serve a request mini-batch from the current cache state and apply
      the policy's update; every per-request StepMetrics field comes back
      with a (B,) leading axis (torch tensors: AÇAI's on its device, the
      baselines' on the CPU).  `ts` are trace positions into the policy's
      `ServerOracle`; None means online (the oracle answers on demand).
      AÇAI ignores `ts`.
    * `spec: PolicySpec` — the spec the policy was built from.
    * `k`, `c_f`, `h` — the cost-model / capacity knobs.
    * `normalized_gain(total_gain, t) -> float` — NAG, Eq. (11).
    * `add_objects` / `remove_objects` / `refresh` — online catalog
      mutation (monotonic ids, never recycled; a removed object is never
      served again; `refresh` rebuilds approximate structures).

    Optional: `replay(reqs (T, d), ts) -> dict` — whole-trace replay
    (`replay_trace` dispatches to it)."""

    spec: "PolicySpec"
    k: int
    c_f: float
    h: int

    def serve_update_batch(self, rs, ts=None) -> StepMetrics:
        ...

    def normalized_gain(self, total_gain: float, t: int) -> float:
        ...


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Serializable policy selection: policy name + build kwargs.

    `name` must be a registered policy (`registered_policies()`: ``acai |
    lru | sim_lru | cls_lru | rnd_lru | qcache``); `params` go verbatim to
    the registered constructor, e.g. ``PolicySpec("sim_lru", {"h": 200,
    "k_prime": 20, "c_theta": 1.5, "augmented": True})`` or
    ``PolicySpec("acai", {"h": 200, "eta": 0.05, "batch": 8})``.  Common
    params: ``h`` (required), ``k``, ``c_f`` (overrides the build-time
    CostModel, so a serialized spec is self-contained), ``augmented``,
    ``seed``.

    Round-trips through a flat dict (`to_dict` / `from_dict`) with the name
    under the ``"policy"`` key; `with_params` derives sweep variants;
    `label` renders a stable row name for benchmark tables."""

    name: str
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "params", dict(self.params))
        if "policy" in self.params:
            raise ValueError("'policy' is the spec field, not a param")

    def __hash__(self):
        return hash((self.name, tuple(sorted(self.params.items()))))

    def to_dict(self) -> Dict[str, Any]:
        """Flat dict form: {'policy': name, **params}."""
        return {"policy": self.name, **self.params}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "PolicySpec":
        d = dict(d)
        try:
            name = d.pop("policy")
        except KeyError:
            raise ValueError(f"policy spec dict needs a 'policy' key: {d}")
        if name not in _REGISTRY:
            raise ValueError(_unknown_policy_msg(name))
        return cls(name, d)

    def with_params(self, **updates) -> "PolicySpec":
        return PolicySpec(self.name, {**self.params, **updates})

    @property
    def label(self) -> str:
        """Name + the params, sorted; floats to 4 significant digits so
        calibrated values keep row names stable across backends."""
        if not self.params:
            return self.name
        parts = [f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                 for k, v in sorted(self.params.items())]
        return f"{self.name}({','.join(parts)})"


def resolve_policy_spec(value) -> "PolicySpec | None":
    """Normalize any user-facing spec form to PolicySpec-or-None: None, a
    PolicySpec, a policy-name string, or the flat dict form."""
    if value is None or isinstance(value, PolicySpec):
        if isinstance(value, PolicySpec) and value.name not in _REGISTRY:
            raise ValueError(_unknown_policy_msg(value.name))
        return value
    if isinstance(value, str):
        if value not in _REGISTRY:
            raise ValueError(_unknown_policy_msg(value))
        return PolicySpec(value)
    if isinstance(value, Mapping):
        return PolicySpec.from_dict(value)
    raise TypeError(f"cannot resolve a policy spec from {value!r}")


def parse_policy_opts(opts) -> Dict[str, Any]:
    """Parse CLI `--policy-opt key=value` pairs into constructor kwargs: the
    index layer's int -> float -> str coercion, then "true" / "false" to
    bools."""
    from repro_torch.index.base import parse_index_opts

    try:
        out = parse_index_opts(opts)
    except ValueError as e:
        raise ValueError(str(e).replace("--index-opt", "--policy-opt"))
    return {k: v.lower() == "true"
            if isinstance(v, str) and v.lower() in ("true", "false") else v
            for k, v in out.items()}


_REGISTRY: Dict[str, Callable] = {}


def register_policy(name: str):
    """Decorator registering `fn(spec, catalog, cost_model, *, oracle,
    index_spec, mesh, seed, answer_cache, device) -> CachePolicy`."""

    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"policy {name!r} already registered")
        _REGISTRY[name] = fn
        return fn

    return deco


def registered_policies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _unknown_policy_msg(name: str) -> str:
    return (f"unknown policy {name!r}; registered: "
            f"{', '.join(registered_policies())}")


def build_policy(spec, catalog, cost_model: CostModel, *, oracle=None,
                 index_spec=None, mesh=None, seed: int = 0,
                 answer_cache=None, device=None) -> CachePolicy:
    """Construct the policy a spec describes over `catalog`.

    spec: a PolicySpec, a registered name or the flat dict.  catalog: (N,
    d) embeddings, numpy or a tensor (AÇAI moves them to `device`; the
    baselines keep a float32 host copy, and their oracle a device copy).
    cost_model supplies (c_f, metric); spec params `c_f` / `metric`
    override it.  oracle: the trace's shared `ServerOracle` (baselines;
    built online on `device` when omitted); AÇAI ignores it.  index_spec:
    AÇAI's remote-catalog index; baselines reject it.  answer_cache:
    AÇAI's answer memo in front of that index (an AnswerCacheSpec, its
    dict, a capacity int or True; baselines reject it).  mesh: not ported
    (AÇAI raises naming A11; baselines reject it as in the reference).
    seed: rounding / randomized-policy
    seed (a spec param `seed` wins).  device: where AÇAI runs and an
    online oracle scans, the card by default.

    Raises ValueError / TypeError for unknown policies and bad params."""
    if isinstance(spec, (str, Mapping)):
        spec = resolve_policy_spec(spec)
    try:
        make = _REGISTRY[spec.name]
    except KeyError:
        raise ValueError(_unknown_policy_msg(spec.name))
    return make(spec, catalog, cost_model, oracle=oracle, index_spec=index_spec,
                mesh=mesh, seed=seed, answer_cache=answer_cache, device=device)


# ---------------------------------------------------------------------------
# AÇAI through the batched step
# ---------------------------------------------------------------------------

def acai_config_from_spec(spec: PolicySpec,
                          cost_model: Optional[CostModel] = None,
                          index_spec=None) -> acai.AcaiConfig:
    """Translate PolicySpec("acai", {...}) + a cost model into AcaiConfig.

    Spec params: h (required), k, c_remote, c_local, eta (default
    0.05 / c_f), mirror, rounding, round_every, and c_f itself (it
    overrides `cost_model`).  `augmented`, `batch` and `seed` are accepted
    and not config fields.  The reference's `debug` counter is not ported
    (an unknown param here)."""
    p = dict(spec.params)
    p.pop("augmented", None)   # AÇAI is the augmented serving rule
    p.pop("batch", None)       # replay-level knob, not a config field
    p.pop("seed", None)
    c_f = p.pop("c_f", None)
    if c_f is None:
        if cost_model is None:
            raise ValueError(
                "acai policy spec needs a cost model: pass cost_model= or "
                "put c_f in the spec params")
        c_f = cost_model.c_f
    try:
        h = p.pop("h")
    except KeyError:
        raise ValueError("acai policy spec needs 'h' (cache capacity)")
    k = p.pop("k", 10)
    eta = p.pop("eta", None)
    oma_kw = {kk: p.pop(kk) for kk in ("mirror", "rounding", "round_every")
              if kk in p}
    oma_kw["eta"] = float(eta) if eta is not None else 0.05 / float(c_f)
    cfg = acai.AcaiConfig(
        h=int(h), k=int(k), c_f=float(c_f),
        c_remote=int(p.pop("c_remote", 64)),
        c_local=int(p.pop("c_local", 16)),
        oma=oma_lib.OMAConfig(**oma_kw), index=index_spec)
    if p:
        raise ValueError(f"unknown acai policy params: {sorted(p)}")
    return cfg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _np(a, dtype=None) -> np.ndarray:
    """A metric field as numpy: tensors from any device; an int default
    stays a 0-d array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


class AcaiPolicy:
    """CachePolicy adapter over `repro_torch.core.policy.AcaiCache`.

    `serve_update_batch` is the cache's batched step (one OMA + rounding
    update a mini-batch); `replay` runs the trace through
    `make_replay_batched`, with the p50 step latency taken on the step
    (a copy of the state, so timing does not advance the replay; the card
    is synchronised before each clock read).  Each step can take its
    rounding uniforms (`u=`, and `uniforms=` (T / batch, N) for a replay),
    so a test can inject the reference's draws."""

    def __init__(self, spec: PolicySpec, catalog, cost_model: CostModel, *,
                 oracle=None, index_spec=None, mesh=None, seed: int = 0,
                 answer_cache=None, device=None):
        del oracle  # AÇAI never consults the server oracle
        self.spec = spec
        self.batch = int(spec.params.get("batch", 1))
        cfg = acai_config_from_spec(spec, cost_model, index_spec=index_spec)
        self.cache = acai.AcaiCache(catalog, cfg, seed=seed, device=device,
                                    mesh=mesh, answer_cache=answer_cache)
        self.cfg = self.cache.cfg

    @property
    def answer_cache(self):
        """The `CachedIndex` wrapper when the answer tier is on (None
        otherwise): the serving engine's fast path and the launcher read
        its hit statistics through it."""
        return self.cache.answer_cache

    k = property(lambda self: self.cfg.k)
    c_f = property(lambda self: self.cfg.c_f)
    h = property(lambda self: self.cfg.h)

    def serve_update_batch(self, rs, ts=None, u=None) -> StepMetrics:
        return self.cache.serve_update_batch(rs, u)

    def serve_update(self, r, t=None, u=None) -> StepMetrics:
        return self.cache.serve_update(r, u)

    # -- online catalog mutation (delegates to AcaiCache) -----------------

    @property
    def live_count(self) -> int:
        """Live (non-tombstoned) catalog objects."""
        return self.cache.live_count

    def add_objects(self, vectors):
        return self.cache.add_objects(vectors)

    def remove_objects(self, ids) -> None:
        self.cache.remove_objects(ids)

    def refresh(self) -> None:
        self.cache.refresh()

    def refresh_start(self) -> None:
        self.cache.refresh_start()

    def refresh_swap(self) -> None:
        self.cache.refresh_swap()

    def compact(self) -> np.ndarray:
        return self.cache.compact()

    def normalized_gain(self, total_gain: float, t: int) -> float:
        return self.cache.normalized_gain(total_gain, t)

    def replay(self, reqs, ts=None, time_reps: int = 5, uniforms=None) -> dict:
        dev = self.cache.device
        if uniforms is not None:
            uniforms = torch.as_tensor(uniforms, dtype=torch.float32).to(dev)
        if self.cache._mutated:
            # the batched replay closes over the static structures; a
            # mutated cache (or one with the answer tier, which serves
            # through the mutable step) replays through its own steps
            return replay_trace_steps(self, reqs, ts, batch=self.batch,
                                      uniforms=uniforms)
        reqs = torch.as_tensor(reqs, dtype=torch.float32).to(dev).contiguous()
        t, b = reqs.shape[0], self.batch
        tt = (t // b) * b
        step = acai.make_step_batched(self.cfg, self.cache._fn_batched, b)
        state0 = self.cache.state  # replay from the cache's current state
        step(acai.copy_state(state0), reqs[:b])  # warm-up (builds kernels)
        times = []
        for _ in range(time_reps):
            s = acai.copy_state(state0)
            _sync(dev)
            t0 = time.perf_counter()
            step(s, reqs[:b])
            _sync(dev)
            times.append(time.perf_counter() - t0)
        replay = acai.make_replay_batched(self.cfg, self.cache._fn_batched, b)
        state, m = replay(state0, reqs[:tt], uniforms)
        self.cache.state = state
        return {
            "gain": _np(m.gain_int, np.float64),
            "cost": _np(m.cost, np.float64),
            "served_local": _np(m.served_local),
            "hit": _np(m.served_local) > 0,
            "fetched": _np(m.fetched),
            "occupancy": _np(m.occupancy, np.float64),
            "p50_step_s": float(np.percentile(times, 50)),
            "requests": int(tt),
        }


# ---------------------------------------------------------------------------
# Baselines through the batched mini-batch step
# ---------------------------------------------------------------------------

class BaselinePolicy:
    """CachePolicy adapter over the sequential LRU-family baselines.

    The update logic is the exact sequential data-structure policy
    (`repro_torch.core.baselines`) with hit tests and serving costs
    vectorized per mini-batch on the host (`KeyValueCache.step_batch`);
    server answers come from the shared per-trace `ServerOracle`, built
    here in online mode on `device` (one scan a mini-batch) when the
    caller passes none.  Metrics are CPU tensors."""

    def __init__(self, spec: PolicySpec, catalog, cost_model: CostModel, *,
                 oracle=None, index_spec=None, mesh=None, seed: int = 0,
                 answer_cache=None, device=None):
        if index_spec is not None:
            raise ValueError(
                f"policy {spec.name!r} serves from the exact server oracle; "
                f"index_spec only applies to 'acai'")
        if mesh is not None:
            raise ValueError(
                f"policy {spec.name!r} is a sequential baseline; mesh= only "
                f"applies to 'acai'")
        if answer_cache is not None:
            raise ValueError(
                f"policy {spec.name!r} serves oracle-exact (memoized) "
                f"answers by construction; answer_cache only applies to "
                f"'acai'")
        self.spec = spec
        p = dict(spec.params)
        p.pop("batch", None)
        cls = B.POLICIES[_BASELINE_CLASS[spec.name]]
        try:
            h = p.pop("h")
        except KeyError:
            raise ValueError(f"{spec.name} policy spec needs 'h'")
        k = int(p.pop("k", 10))
        c_f = float(p.pop("c_f", cost_model.c_f))
        metric = p.pop("metric", cost_model.metric)
        seed = int(p.pop("seed", seed))
        kmax = max(k, int(p.get("k_prime") or k), 1)
        catalog = B.host_f32(catalog)
        if oracle is None:
            # online mode: answers computed per mini-batch, only the latest
            # block retained (the serving tier runs unbounded)
            oracle = B.ServerOracle(catalog, kmax=max(kmax, 16),
                                    retain_all=False, device=device)
        if oracle.kmax < kmax:
            raise ValueError(
                f"shared oracle holds kmax={oracle.kmax} answers but "
                f"{spec.name} needs {kmax} (k/k_prime)")
        self.oracle = oracle
        self.policy = cls(catalog, oracle, h=int(h), k=k, c_f=c_f,
                          metric=metric, seed=seed, **p)

    k = property(lambda self: self.policy.k)
    c_f = property(lambda self: self.policy.c_f)
    h = property(lambda self: self.policy.h)

    def serve_update_batch(self, rs, ts=None) -> StepMetrics:
        from repro_torch.index.base import check_finite_queries

        rs = np.atleast_2d(B.host_f32(rs))
        check_finite_queries(torch.from_numpy(rs), f"{self.spec.name}.serve_update_batch")
        if ts is None:  # online mode: answer the new requests on demand
            ts = self.oracle.extend(rs)
        results = self.policy.step_batch(np.asarray(ts), rs)
        b = len(results)
        occ = float(len(self.policy.cached_object_ids()))

        def zeros():
            return torch.zeros(b, dtype=torch.int32)

        gain = torch.tensor([r.gain for r in results], dtype=torch.float64)
        return StepMetrics(
            gain_int=gain, gain_frac=gain.clone(),
            cost=torch.tensor([r.cost for r in results], dtype=torch.float64),
            served_local=torch.tensor([r.served_local for r in results],
                                      dtype=torch.int32),
            fetched=torch.tensor([r.fetched for r in results], dtype=torch.int32),
            occupancy=torch.full((b,), occ, dtype=torch.float64),
            local_overflow=zeros(), degraded=zeros(), shed=zeros(),
            remote_failures=zeros(), retries=zeros(), deadline_misses=zeros(),
            answer_hits=zeros(), answer_misses=zeros(),
            answer_invalidations=zeros())

    def serve_update(self, r, t=None) -> StepMetrics:
        ts = None if t is None else np.asarray([t])
        return first_row(self.serve_update_batch(np.atleast_2d(B.host_f32(r)), ts))

    # -- online catalog mutation ------------------------------------------

    def add_objects(self, vectors) -> np.ndarray:
        """Admit new objects: the oracle learns the rows (precomputed
        answers go stale: serve with ts=None after a mutation) and the
        policy's catalog reference follows."""
        ids = self.oracle.add_objects(vectors)
        self.policy.catalog = self.oracle.catalog
        return ids

    def remove_objects(self, ids) -> None:
        """Expire objects: tombstoned in the oracle and every cached entry
        referencing them evicted, so a removed object is never served."""
        self.oracle.remove_objects(ids)
        self.policy.catalog = self.oracle.catalog
        self.policy.drop_objects(ids)

    def refresh(self) -> None:
        """No-op: baseline serving is oracle-exact (nothing drifts)."""

    def refresh_start(self) -> None:
        """No-op: nothing to shadow-rebuild (see refresh)."""

    def refresh_swap(self) -> None:
        """No-op: nothing to swap (see refresh)."""

    def compact(self) -> np.ndarray:
        """Epoch compaction: the oracle drops tombstoned rows and
        renumbers; cached entries' value ids follow the remap.  Returns the
        old -> new id remap (-1 = dead)."""
        remap = self.oracle.compact()
        self.policy.catalog = self.oracle.catalog
        self.policy.remap_objects(remap)
        return remap

    def normalized_gain(self, total_gain: float, t: int) -> float:
        return float(total_gain) / (self.k * self.c_f * max(t, 1))


# `spec name -> baselines.POLICIES key` (the paper's display names)
_BASELINE_CLASS = {
    "lru": "LRU",
    "sim_lru": "SIM-LRU",
    "cls_lru": "CLS-LRU",
    "rnd_lru": "RND-LRU",
    "qcache": "QCACHE",
}

register_policy("acai")(AcaiPolicy)
for _name in _BASELINE_CLASS:
    register_policy(_name)(BaselinePolicy)


def replay_trace(pol: CachePolicy, reqs, ts=None, *, batch: int = 8,
                 **replay_kw) -> dict:
    """Drive a whole trace through a policy: its native `replay` when it
    has one (AÇAI; `replay_kw`, e.g. `uniforms=`, go to it), else
    `replay_trace_steps`."""
    if hasattr(pol, "replay"):
        return pol.replay(reqs, ts, **replay_kw)
    if replay_kw:
        raise TypeError(f"{type(pol).__name__} has no native replay for "
                        f"{sorted(replay_kw)}")
    return replay_trace_steps(pol, reqs, ts, batch=batch)


def replay_trace_steps(pol: CachePolicy, reqs, ts=None, *,
                       batch: int = 8, uniforms=None) -> dict:
    """The mini-batch stepping loop behind `replay_trace`: mini-batches of
    `batch` requests (a tail that does not fill one is dropped, as
    make_replay_batched does), per-request metric arrays and the p50 step
    latency (host clock; AÇAI's device is synchronised around a step).
    `uniforms` (T / batch, N), AÇAI only, injects each step's rounding
    uniforms.  The batches go to the policy on the host."""
    reqs = np.asarray(reqs)
    t = reqs.shape[0]
    tt = (t // batch) * batch
    if tt == 0:
        raise ValueError(
            f"trace of {t} requests is shorter than one mini-batch "
            f"(batch={batch}); shrink batch or extend the trace")
    dev = getattr(getattr(pol, "cache", None), "device", torch.device("cpu"))
    out = {k: [] for k in ("gain", "cost", "served_local", "fetched",
                           "occupancy", "answer_hits",
                           "answer_invalidations")}
    times = []
    for s in range(0, tt, batch):
        _sync(dev)
        t0 = time.perf_counter()
        # ts=None stays None per batch: the online-oracle path must fire
        kw = {} if uniforms is None else {"u": uniforms[s // batch]}
        m = pol.serve_update_batch(reqs[s:s + batch],
                                   None if ts is None else ts[s:s + batch], **kw)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        out["gain"].append(_np(m.gain_int, np.float64))
        out["cost"].append(_np(m.cost, np.float64))
        out["served_local"].append(_np(m.served_local))
        out["fetched"].append(_np(m.fetched))
        out["occupancy"].append(_np(m.occupancy, np.float64))
        # answer-tier counters: 0 everywhere while the tier is off (an int
        # default broadcasts to per-request zeros)
        out["answer_hits"].append(np.broadcast_to(_np(m.answer_hits), (batch,)))
        out["answer_invalidations"].append(
            np.broadcast_to(_np(m.answer_invalidations), (batch,)))
    res = {k: np.concatenate(v) for k, v in out.items()}
    res["hit"] = res["served_local"] > 0
    res["p50_step_s"] = float(np.percentile(times, 50)) if times else 0.0
    res["requests"] = int(tt)
    return res


def replay_trace_online(pol: CachePolicy, reqs, arrivals, *,
                        former=None, admission=None, service=None,
                        catalog=None, events=(), slo_ms=None) -> dict:
    """Drive a trace through the online serving engine
    (`repro_torch.serve.queue`): requests arrive on the virtual clock per
    `arrivals` (an `ArrivalSpec`, a times array or a ready source), queue,
    are coalesced by the dynamic batch former and may be shed by admission
    control, so the result adds queueing, latency and shed fields to the
    per-request gain / cost arrays.  Works for every registered policy
    (the engine calls `serve_update_batch(rs, None)` and, with `events`,
    the mutation surface).  The defaults are BatchFormerConfig(),
    AdmissionConfig() and ServiceModel()."""
    from repro_torch.serve.queue import (AdmissionConfig, BatchFormerConfig,
                                         ServiceModel, serve_trace_online)

    return serve_trace_online(
        pol, reqs, arrivals,
        former=BatchFormerConfig() if former is None else former,
        admission=AdmissionConfig() if admission is None else admission,
        service=ServiceModel() if service is None else service,
        catalog=catalog, events=events, slo_ms=slo_ms)


# Smallest sensible spec params per registered policy (fractions of a
# second on a tiny trace), the reference's table; AÇAI pins depround
# rounding so the occupancy-<=-h invariant is exact.
TINY_POLICY_KWARGS = {
    "acai": {"h": 16, "k": 4, "c_remote": 12, "c_local": 8, "eta": 0.05,
             "rounding": "depround", "batch": 8},
    "lru": {"h": 16, "k": 4},
    "sim_lru": {"h": 16, "k": 4, "k_prime": 8, "c_theta": 1.5},
    "cls_lru": {"h": 16, "k": 4, "k_prime": 8, "c_theta": 1.5},
    "rnd_lru": {"h": 16, "k": 4, "k_prime": 8, "c_theta": 1.5},
    "qcache": {"h": 16, "k": 4},
}
