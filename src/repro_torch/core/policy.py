"""AÇAI policy: request serving + OMA cache updates (paper Sec. IV).

Port of `repro.core.policy`.  The batched step serves a mini-batch of
requests against the same cache state: candidate generation from the
remote index plus a scan of the cached rows, serving by Eq. (2), gain
and subgradient by Eq. (55), one averaged OMA step with the
capped-simplex projection, then rounding.  A replay is a Python loop of
steps where the reference scans.

Mutable catalog: `AcaiCache.add_objects / remove_objects / refresh* /
compact` change the catalog online.  After the first mutation the cache
serves through `make_mutable_step`: the candidate slab comes from the
live structures (`exact_mutable_candidates` or the index's
`mutable_index_candidate_fn`), and the tail keeps y = x = 0 on dead rows.
The state's length is the slab's capacity, so are the rounding uniforms.

Randomness: the reference splits a `jax.random` key per step for the
rounding.  Here the state carries a `torch.Generator`, and every step also
accepts its uniforms explicitly, so a test can feed it the numbers the
reference drew from its own keys.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device, spans
from repro_torch.core import gain as gain_lib
from repro_torch.core import oma as oma_lib
from repro_torch.core import rounding as rounding_lib
from repro_torch.core.costs import BIG_COST, pairwise_dissimilarity
from repro_torch.index.base import (build_index, check_finite_queries, check_removable,
                                    compact_rows, grow_rows, live_remap, resolve_spec,
                                    run_device, slab_append)
from repro_torch.kernels.ref import smallest_k

_SERVE, _SCATTER, _OMA, _ROUND = (spans.span(p) for p in ("serve", "scatter", "oma", "round"))
_UPLOAD = spans.wait("upload")


class StepMetrics(NamedTuple):
    gain_int: torch.Tensor      # G(r_t, x_t) — what the system earns
    gain_frac: torch.Tensor     # G(r_t, y_t) — fractional gain (analysis)
    cost: torch.Tensor          # C(r_t, x_t)
    served_local: torch.Tensor  # answers served from the cache
    fetched: torch.Tensor       # cache-update traffic (objects fetched)
    occupancy: torch.Tensor     # sum x_{t+1}
    # the reference's debug counter (cached rows past the candidate
    # generator's gather; not ported, so 0)
    local_overflow: torch.Tensor | int = 0
    # resilient-serving counters: 0 on the fault-free path, filled by
    # repro_torch.serve.resilience when a remote backend is attached
    degraded: torch.Tensor | int = 0         # served locally under failure
    shed: torch.Tensor | int = 0             # failed, nothing local in ceiling
    remote_failures: torch.Tensor | int = 0  # the request's remote tier failed
    retries: torch.Tensor | int = 0          # extra attempts beyond the first
    deadline_misses: torch.Tensor | int = 0  # deadline budget exceeded
    # answer-tier counters: 0 without an answer cache, booked on the host
    # (int32 CPU tensors) by AcaiCache._serve_batch_direct
    answer_hits: torch.Tensor | int = 0      # the request's answer was memoized
    answer_misses: torch.Tensor | int = 0    # the request needed the scan
    answer_invalidations: torch.Tensor | int = 0  # entries dropped by churn
    #                                               since the previous step
    #                                               (on the batch's first row)


def shed_only_metrics(batch: int) -> StepMetrics:
    """StepMetrics rows for requests that never reached a policy step:
    zero gain, cost and occupancy with shed = 1 on every row (CPU tensors).

    The online serving engine's admission control books its victims
    through this helper, so engine-level shedding lands in the same
    counters the resilient tier fills."""
    zf = torch.zeros(batch, dtype=torch.float64)
    zi = torch.zeros(batch, dtype=torch.int32)
    return StepMetrics(
        gain_int=zf, gain_frac=zf.clone(), cost=zf.clone(),
        served_local=zi, fetched=zi.clone(), occupancy=zf.clone(),
        local_overflow=zi.clone(), degraded=zi.clone(),
        shed=torch.ones(batch, dtype=torch.int32), remote_failures=zi.clone(),
        retries=zi.clone(), deadline_misses=zi.clone(),
        answer_hits=zi.clone(), answer_misses=zi.clone(),
        answer_invalidations=zi.clone())


def first_row(m: StepMetrics) -> StepMetrics:
    """The B = 1 view of batched metrics: row 0 of every per-request field;
    a plain int default passes through."""
    return StepMetrics(*(f[0] if isinstance(f, torch.Tensor) and f.dim() else f
                         for f in m))


class CacheState(NamedTuple):
    y: torch.Tensor            # (N,) fractional state
    x: torch.Tensor            # (N,) physical cache indicator
    t: int                     # requests served so far
    gen: torch.Generator       # rounding uniforms, on the state's device


def dedup_mask_batched(ids: torch.Tensor, n: int) -> torch.Tensor:
    """valid[b, i] = ids[b, i] is a real id (< n) and its first occurrence
    in row b (stable sort, so the first slot of a duplicate wins)."""
    order = torch.sort(ids, dim=1, stable=True).indices
    sorted_ids = torch.gather(ids, 1, order)
    dup_sorted = torch.zeros_like(ids, dtype=torch.bool)
    dup_sorted[:, 1:] = sorted_ids[:, 1:] == sorted_ids[:, :-1]
    dup = torch.empty_like(dup_sorted).scatter_(1, order, dup_sorted)
    return (ids < n) & ~dup


def dedup_mask(ids: torch.Tensor, n: int) -> torch.Tensor:
    return dedup_mask_batched(ids[None], n)[0]


def exact_mutable_candidates(rs: torch.Tensor, x: torch.Tensor, catalog: torch.Tensor,
                             alive, c_remote: int, c_local: int,
                             metric: str = "sqeuclidean"):
    """(ids, d, valid), each (B, C): exact search on both sides from one
    (B, N) distance matrix (the `pairwise_l2` kernel).  `alive` (N,) bool,
    the catalog slab's liveness, sets tombstoned and unused rows to +inf:
    a dead row is picked only when fewer than c_remote rows live, and then
    resolves to the invalid id N.  With alive None the catalog is static."""
    n = catalog.shape[0]
    b = rs.shape[0]
    d_full = pairwise_dissimilarity(rs.contiguous(), catalog, metric)   # (B, N)
    inf = torch.full((), float("inf"), device=d_full.device)
    if alive is not None:
        d_full = torch.where(alive[None, :], d_full, inf)
    d_remote, ids_remote = smallest_k(d_full, c_remote)
    if alive is not None:
        ids_remote = torch.where(torch.isfinite(d_remote), ids_remote,
                                 torch.full_like(ids_remote, n))
    d_cached = torch.where(x[None, :] > 0.5, d_full, inf)
    ids_local = smallest_k(d_cached, c_local)[1]
    ids = torch.cat([ids_remote, ids_local], dim=1)
    valid = dedup_mask_batched(ids, n)
    # a "local" candidate slot is only valid if that object is cached (the
    # y = x = 0 invariant on dead rows keeps removed objects out here too)
    cached_ok = torch.cat([torch.ones((b, c_remote), dtype=torch.bool, device=x.device),
                           x[ids_local] > 0.5], dim=1)
    valid = valid & cached_ok
    d = torch.where(valid, torch.gather(d_full, 1, torch.clamp(ids, 0, n - 1)),
                    torch.full(ids.shape, BIG_COST, device=x.device))
    return ids, d, valid


def exact_candidate_fn_batched(catalog: torch.Tensor, c_remote: int,
                               c_local: int, metric: str = "sqeuclidean") -> Callable:
    """Batched candidate generator backed by exact search on both sides:
    fn(rs (B, d), x (N,)) -> (ids, d, valid), each (B, C).  One (B, N)
    distance matrix from the `pairwise_l2` kernel feeds both the remote
    top-k and the cached-row top-k."""

    def fn(rs: torch.Tensor, x: torch.Tensor):
        return exact_mutable_candidates(rs, x, catalog, None, c_remote, c_local, metric)

    return fn


def per_request_view(candidate_fn_batched: Callable) -> Callable:
    """A batched candidate generator as the per-request fn(r (d,), x (N,))
    -> (ids (C,), d (C,), valid (C,)): its B = 1 view, so sequential and
    batched replays share one code path (`batched_view` goes the other
    way).  A generator's `local_cap` carries over."""

    def fn(r: torch.Tensor, x: torch.Tensor):
        ids, d, valid = candidate_fn_batched(r[None, :], x)
        return ids[0], d[0], valid[0]

    if hasattr(candidate_fn_batched, "local_cap"):
        fn.local_cap = candidate_fn_batched.local_cap
    return fn


def exact_candidate_fn(catalog: torch.Tensor, c_remote: int, c_local: int,
                       metric: str = "sqeuclidean") -> Callable:
    """Per-request view of `exact_candidate_fn_batched` (B = 1)."""
    return per_request_view(exact_candidate_fn_batched(catalog, c_remote, c_local, metric))


@dataclasses.dataclass(frozen=True)
class AcaiConfig:
    h: int                      # cache capacity (objects)
    k: int = 10                 # answers per request
    c_f: float = 1.0            # fetching cost
    c_remote: int = 64          # remote-index candidates (>= k!)
    c_local: int = 16           # local-index candidates
    oma: oma_lib.OMAConfig = dataclasses.field(default_factory=oma_lib.OMAConfig)
    # remote-catalog index: an IndexSpec (e.g. IndexSpec("ivf", {...}))
    # makes AcaiCache build it through the registry; None = exact candidates
    index: object = None


def scaled_config(cfg: AcaiConfig, batch: int,
                  eta_scale: float | None = None) -> AcaiConfig:
    """Mini-batch learning-rate scaling: one averaged OMA step moves as
    far as `batch` sequential steps to first order."""
    scale = float(batch) if eta_scale is None else float(eta_scale)
    return dataclasses.replace(
        cfg, oma=dataclasses.replace(cfg.oma, eta=cfg.oma.eta * scale))


def draw_uniforms(state: CacheState) -> torch.Tensor:
    """The N rounding uniforms of one step, from the state's generator."""
    return torch.rand(state.y.shape[0], generator=state.gen,
                      device=state.y.device, dtype=state.y.dtype)


def _round_state(cfg: AcaiConfig, u, y_new, y_old, x_old, t: int, width: int = 1):
    mode = cfg.oma.rounding
    if mode == "coupled":
        return rounding_lib.coupled_rounding(u, x_old, y_old, y_new)
    if mode == "independent":
        return rounding_lib.independent_rounding(u, y_new)
    if mode == "depround":
        # re-round every M requests: fire iff a multiple of M lands in the
        # batch's window [t, t + width), else keep x
        if (-t) % cfg.oma.round_every < width:
            return rounding_lib.depround(u, y_new)
        return x_old
    raise ValueError(mode)


def finish_step_batched(cfg_up: AcaiConfig, state: CacheState, u, batch: int,
                        y_new, gain_int, gain_frac, cost, served_local):
    """Rounding + metric assembly + state advance: `fetched` books the
    batch's cache-update traffic on its last request, `occupancy` repeats
    the post-update value."""
    with _ROUND:
        x_new = _round_state(cfg_up, u, y_new, state.y, state.x, state.t, width=batch)
        moved = rounding_lib.movement(x_new, state.x)
        fetched = torch.zeros((batch,), dtype=moved.dtype, device=state.y.device)
        fetched[-1] = moved
        metrics = StepMetrics(
            gain_int=gain_int, gain_frac=gain_frac, cost=cost,
            served_local=served_local, fetched=fetched,
            occupancy=torch.sum(x_new).expand(batch).clone())
    return CacheState(y_new, x_new, state.t + batch, state.gen), metrics


def scatter_rows_sum(n: int, ids: torch.Tensor, vals: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """(n,) float: for each id, the sum of `vals` over the valid slots of
    (B, C) `ids` that name it (the reference's `.at[ids].add`), in an order
    fixed by the data alone, so two runs on the card agree to the last bit
    (atomics, as `index_add_` uses on CUDA, add duplicates in a different
    order each run).

    A stable sort of the B * C slots by id puts each id's slots together,
    in row order; a row names a valid id at most once (the candidate slab
    is deduplicated), so a run holds at most B values.  They are laid out
    in a (B * C, B) table at (run start, rank in run) and summed along the
    rank, and each run's head writes its sum.  Invalid slots go to a spare
    id n, dropped at the end.  No step reads the device back."""
    b = ids.shape[0]
    dev = vals.device
    flat = torch.where(valid, ids, torch.full_like(ids, n)).reshape(-1)
    v = torch.where(valid, vals, torch.zeros_like(vals)).reshape(-1)
    sid, order = torch.sort(flat, stable=True)
    sv = v[order]
    pos = torch.arange(sid.shape[0], device=dev)
    head = torch.ones_like(sid, dtype=torch.bool)
    head[1:] = sid[1:] != sid[:-1]
    start = torch.cummax(torch.where(head, pos, torch.zeros_like(pos)), 0).values
    # only the spare id's run can exceed b slots; its values are all 0
    rank = torch.clamp_max(pos - start, b - 1)
    table = torch.zeros((sid.shape[0], b), dtype=vals.dtype, device=dev)
    table[start, rank] = sv
    out = torch.zeros(n + 1, dtype=vals.dtype, device=dev)
    out[torch.where(head, sid, torch.full_like(sid, n))] = table.sum(dim=1)
    return out[:n]


def apply_candidates_batched(cfg: AcaiConfig, cfg_up: AcaiConfig,
                             state: CacheState, batch: int, ids, d, valid, u=None,
                             alive=None):
    """Serve + update tail of a mini-batch step on a candidate slab
    (ids, d, valid) of shape (B, C).  `u` holds the step's N rounding
    uniforms (drawn from the state's generator when None).  `alive` (N,)
    bool, on a mutable catalog, keeps y = 0 on dead rows after the OMA
    step (the projection's floor would give them mass again)."""
    n = state.y.shape[0]
    with _SERVE:
        ids_c = torch.clamp_max(ids, n - 1)
        zero = torch.zeros((), dtype=state.y.dtype, device=state.y.device)
        x_cand = torch.where(valid, state.x[ids_c], zero)
        y_cand = torch.where(valid, state.y[ids_c], zero)

        served = gain_lib.serve_batch(d, x_cand, cfg.k, cfg.c_f)
        gain_frac, g_cand = gain_lib.gain_and_subgradient_batch(d, y_cand, cfg.k, cfg.c_f)
        served_local = torch.sum(served.from_cache.to(torch.int32), dim=1)

    with _SCATTER:
        # the reference's .at[].add scatter, in a fixed order (scatter_rows_sum)
        g_full = scatter_rows_sum(n, ids_c, g_cand / batch, valid)
    with _OMA:
        y_new = oma_lib.oma_update(state.y, g_full, cfg.h, cfg_up.oma)
        if alive is not None:
            y_new = torch.where(alive, y_new, zero)
    if u is None:
        u = draw_uniforms(state)
    return finish_step_batched(cfg_up, state, u, batch, y_new, served.gain, gain_frac,
                               served.cost, served_local)


def make_step_batched(cfg: AcaiConfig, candidate_fn_batched: Callable, batch: int,
                      eta_scale: float | None = None) -> Callable:
    """Mini-batch step: (state, rs (B, d), u=None) -> (state', StepMetrics (B,)).

    All B requests are served and differentiated against the same x_t /
    y_t, the subgradients are batch-averaged, and one OMA + projection +
    rounding update advances the state; eta is scaled by `eta_scale`
    (default B)."""
    cfg_up = scaled_config(cfg, batch, eta_scale)

    def step(state: CacheState, rs: torch.Tensor, u=None):
        ids, d, valid = candidate_fn_batched(rs, state.x)
        return apply_candidates_batched(cfg, cfg_up, state, batch, ids, d, valid, u=u)

    return step


def _concat_metrics(ms) -> StepMetrics:
    """Per-step metrics joined along the request axis; an int default
    field stays an int."""
    return StepMetrics(*(torch.cat(f) if isinstance(f[0], torch.Tensor) else f[0]
                         for f in zip(*ms)))


def make_mutable_step(cfg: AcaiConfig, batch: int,
                      eta_scale: float | None = None) -> Callable:
    """The mutable catalog's tail: (state, ids, d, valid, alive, u=None) ->
    (state', StepMetrics (B,)).  The candidate slab is built by the caller
    against the live structures; `alive` is the slab's liveness.  With
    every row alive the state advances as `make_step_batched`'s."""
    cfg_up = scaled_config(cfg, batch, eta_scale)

    def step(state: CacheState, ids, d, valid, alive, u=None):
        return apply_candidates_batched(cfg, cfg_up, state, batch, ids, d, valid, u=u,
                                        alive=alive)

    return step


def make_replay_from_step(step: Callable, batch: int) -> Callable:
    """A mini-batch step ((state, rs (B, d), u) -> (state', metrics (B,)))
    as a whole-trace replay: (state, requests (T, d), uniforms=None) ->
    (state', StepMetrics (T,)).  T must divide by `batch`; `uniforms`,
    when given, holds one row of rounding uniforms per step."""

    def replay(state: CacheState, requests: torch.Tensor, uniforms=None):
        t = requests.shape[0]
        if t % batch:
            raise ValueError(f"trace length {t} must divide by batch size {batch}")
        ms = []
        for i in range(t // batch):
            u = None if uniforms is None else uniforms[i]
            state, m = step(state, requests[i * batch:(i + 1) * batch], u)
            ms.append(m)
        return state, _concat_metrics(ms)

    return replay


def make_replay_batched(cfg: AcaiConfig, candidate_fn_batched: Callable, batch: int,
                        eta_scale: float | None = None) -> Callable:
    """Whole-trace replay: (state, requests (T, d), uniforms=None) ->
    (state', StepMetrics (T,)).  T must divide by `batch`; `uniforms`, when
    given, holds one row of rounding uniforms per step, (T / batch, N)."""
    return make_replay_from_step(
        make_step_batched(cfg, candidate_fn_batched, batch, eta_scale), batch)


def make_step(cfg: AcaiConfig, candidate_fn_batched: Callable) -> Callable:
    """Per-request step: (state, r (d,), u=None) -> (state', StepMetrics of
    scalars) — the B = 1 view of the batched step (eta unscaled)."""
    step = make_step_batched(cfg, candidate_fn_batched, 1)

    def step1(state: CacheState, r: torch.Tensor, u=None):
        state, m = step(state, r[None, :], u)
        return state, first_row(m)

    return step1


def make_replay(cfg: AcaiConfig, candidate_fn_batched: Callable) -> Callable:
    """Per-request replay: the B = 1 batched replay."""
    return make_replay_batched(cfg, candidate_fn_batched, 1)


def init_state(n: int, cfg: AcaiConfig, seed: int = 0, start: str = "uniform",
               device=None, u0=None) -> CacheState:
    """start='uniform': y_1 = argmin Phi (Alg. 1 line 1), x_1 by DepRound
    on the host; 'empty': cold cache.  DepRound's N - 1 uniforms are `u0`
    when given, else drawn from a CPU generator seeded with `seed`; the
    state's step generator lives on `device`, seeded with `seed`."""
    device = resolve_device(device)
    y = oma_lib.uniform_state(n, cfg.h, device=device)
    if start == "uniform":
        if u0 is None:
            u0 = torch.rand(max(n - 1, 0), generator=torch.Generator().manual_seed(seed))
        x = rounding_lib.depround(u0, y)
    else:
        x = torch.zeros((n,), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return CacheState(y=y, x=x, t=0, gen=gen)


def copy_state(state: CacheState, seed: int = 0) -> CacheState:
    """An independent copy of a state (fresh generator seeded `seed`),
    e.g. to start several runs from one host DepRound."""
    gen = torch.Generator(device=state.y.device).manual_seed(seed)
    return CacheState(state.y.clone(), state.x.clone(), state.t, gen)


def host_rows(rs):
    """A (B, d) float32 numpy copy of a request batch that lies on the host
    (numpy, a list or a CPU tensor), else None: the answer tier hashes
    these bytes, so a batch on the card is never read back for its keys."""
    if isinstance(rs, torch.Tensor):
        if rs.device.type != "cpu":
            return None
        rs = rs.detach().numpy()
    return np.atleast_2d(np.ascontiguousarray(rs, dtype=np.float32))


def batched_view(candidate_fn: Callable) -> Callable:
    """A per-request generator fn(r (d,), x) -> (ids (C,), d (C,), valid
    (C,)) as a batched one: the requests one after another, the outputs
    stacked (the reference vmaps it)."""

    def fn(rs: torch.Tensor, x: torch.Tensor):
        outs = [candidate_fn(r, x) for r in rs]
        return tuple(torch.stack(t) for t in zip(*outs))

    return fn


class AcaiCache:
    """Object API over the batched step, for a serving tier: requests
    arrive one by one (`serve_update`) or in batches (`serve_update_batch`).

    `cfg` is an AcaiConfig, or the reference's serialized forms of the
    'acai' policy: a PolicySpec, its flat dict or the name (a spec
    without `c_f` takes the `c_f` kwarg).  The remote-catalog index comes
    from `cfg.index`: an IndexSpec builds it through the registry and
    wires it in with `index_candidate_fn_batched`; None gives exact
    candidates.  The escape hatches `candidate_fn` (per request) and
    `candidate_fn_batched` override the spec-built generator (passing one
    beside `cfg.index` warns, as in the reference).  The catalog mutates
    online (`add_objects`, `remove_objects`, `refresh*`, `compact`).

    `answer_cache` (an AnswerCacheSpec, its dict, a capacity int or True)
    fronts the spec-built index with the exact answer memo
    (`repro_torch.serve.answer_cache.CachedIndex`), and the cache then
    serves through the mutable step from step 0 (the step that queries
    the index eagerly, where the memo sits).  `remote` / `resilience`
    attach the resilient remote tier (`attach_remote`).  `state` starts
    the cache from a given CacheState (it must lie on `device`) instead of
    running `init_state`.

    `mesh` (a DeviceMesh with a `model` axis, `repro_torch.launch.mesh`)
    serves through the sharded step (`repro_torch.core.distributed`): each
    rank keeps its block of the catalog and of y and x (`catalog` and a
    given `state` are the whole ones, cut here), and every rank of the
    world calls every method with the same arguments.  `cfg.index` may
    name the sharded backend (`ivf_sharded`) or be None for the exact
    sharded scan; `sharded_kwargs` (e.g. `scan_chunk`, `top_a`) configure
    the step; `device` defaults to the mesh's.  On a mesh the catalog
    mutates through the exact masked scan only; the answer tier and the
    resilient tier raise NotImplementedError, as in the reference.  The
    cache's `catalog`, `valid` and `state` are then this rank's blocks;
    ids in and out stay global."""

    def __init__(self, catalog, cfg, seed: int = 0, device=None,
                 state: CacheState | None = None, mesh=None, remote=None,
                 resilience=None, answer_cache=None, candidate_fn=None,
                 candidate_fn_batched=None, c_f: float | None = None,
                 sharded_kwargs: dict | None = None):
        if not isinstance(cfg, AcaiConfig):
            from repro_torch.core.costs import CostModel
            from repro_torch.core.policy_api import (acai_config_from_spec,
                                                     resolve_policy_spec)

            spec = resolve_policy_spec(cfg)
            if spec is None or spec.name != "acai":
                raise ValueError(
                    f"AcaiCache builds the 'acai' policy; got "
                    f"{getattr(spec, 'name', spec)!r} — use "
                    f"repro_torch.core.policy_api.build_policy for baselines")
            cfg = acai_config_from_spec(spec, None if c_f is None else CostModel(c_f=c_f))
        elif c_f is not None:
            raise ValueError("c_f= only applies to the PolicySpec form "
                             "(AcaiConfig already carries its c_f)")
        resolved = resolve_spec(cfg.index)
        if resolved is not cfg.index:
            cfg = dataclasses.replace(cfg, index=resolved)
        self.cfg = cfg
        self.mesh = mesh
        self.spans = spans.Recorder()   # host time a step by phase, waits
        self._sharded_kwargs = dict(sharded_kwargs or {})
        self.index = None  # the spec-built index (None: exact or escape hatch)
        # mutable-catalog bookkeeping: the cache serves the static step
        # until the first mutation, then the mutable one (make_mutable_step)
        self._mutated = False
        self._mut_fn: Callable | None = None
        self._mut_steps: dict[int, Callable] = {}
        self._bsteps: dict[int, Callable] = {}
        self._res = None  # the resilient mode: None until a remote is attached
        explicit = candidate_fn is not None or candidate_fn_batched is not None
        self._custom_fn = explicit
        if explicit and cfg.index is not None:
            import warnings

            warnings.warn("AcaiCache: cfg.index is set but " + (
                "a mesh was given — the sharded step ignores explicit candidate fns "
                "and serves from the spec-built index" if mesh is not None else
                "explicit candidate_fn/candidate_fn_batched overrides it — drop the "
                "kwargs or the spec"), DeprecationWarning, stacklevel=2)
        if mesh is not None:
            self._init_sharded(catalog, device, seed, state, answer_cache)
            if remote is not None or resilience is not None:
                self.attach_remote(remote, resilience)
            return
        self.device = resolve_device(device)
        self.catalog = torch.as_tensor(catalog, dtype=torch.float32).to(
            self.device).contiguous()
        n = self.catalog.shape[0]
        self.valid = torch.ones(n, dtype=torch.bool, device=self.device)
        self._live = self._n_slots = n
        if candidate_fn_batched is not None:
            self._fn_batched = candidate_fn_batched
        elif candidate_fn is not None:
            self._fn_batched = batched_view(candidate_fn)
        elif cfg.index is not None:
            from repro_torch.index.candidates import index_candidate_fn_batched

            self.index = build_index(cfg.index, self.catalog, device=self.device)
            self._fn_batched = index_candidate_fn_batched(
                self.index, self.catalog, cfg.c_remote, cfg.c_local, h=cfg.h)
        else:
            self._fn_batched = exact_candidate_fn_batched(
                self.catalog, cfg.c_remote, cfg.c_local)
        # the answer tier: a CachedIndex around the spec-built index, served
        # through the mutable step, whose eager `index.query` is where the
        # memo sits
        from repro_torch.serve.answer_cache import CachedIndex, resolve_answer_cache_spec

        self.answer_cache = None
        ac_spec = resolve_answer_cache_spec(answer_cache)
        if ac_spec is not None:
            if self._custom_fn:
                raise ValueError(
                    "answer_cache= cannot front an explicit candidate_fn*: the "
                    "tier memoizes `Index.query` answers — drop the escape "
                    "hatch or the spec")
            if self.index is None:
                raise ValueError(
                    "answer_cache= fronts an index backend; set cfg.index "
                    "(IndexSpec('flat') gives the exact fused scan)")
            self.index = self.answer_cache = CachedIndex(self.index, ac_spec)
            self._enter_mutable()
        if state is None:
            state = init_state(n, cfg, seed=seed, device=self.device)
        elif state.y.device != self.device or state.y.shape[0] != n:
            raise ValueError("state must lie on the cache's device and match "
                             "the catalog size")
        self.state = state
        if remote is not None or resilience is not None:
            self.attach_remote(remote, resilience)

    def _init_sharded(self, catalog, device, seed: int, state, answer_cache) -> None:
        """The mesh half of the constructor: the sharded index (built over
        the whole catalog before anything else), then this rank's blocks
        of the catalog and of the state."""
        from repro_torch.core import distributed as dist_lib
        from repro_torch.index.base import registered_backends
        from repro_torch.serve.answer_cache import resolve_answer_cache_spec

        mesh, cfg = self.mesh, self.cfg
        # the configuration is checked before the mesh is touched and
        # before any build
        if cfg.index is not None and cfg.index.backend not in registered_backends(
                sharded=True):
            raise ValueError(
                f"cfg.index backend {cfg.index.backend!r} is not a sharded layout; with "
                f"mesh= use one of {registered_backends(sharded=True)} (or index=None "
                f"for the exact sharded scan)")
        if resolve_answer_cache_spec(answer_cache) is not None:
            raise NotImplementedError(
                "answer_cache= on a sharded mesh is not implemented (the sharded step "
                "owns candidate generation) — use a single-device cache")
        self.device = (dist_lib.mesh_device(mesh) if device is None
                       else resolve_device(device))
        if self.device.type != mesh.device_type:
            raise ValueError(f"device {self.device} is not the mesh's "
                             f"({mesh.device_type})")
        axis = self._model_axis()
        full = torch.as_tensor(catalog, dtype=torch.float32)
        n = full.shape[0]
        p = dist_lib._axis_size(mesh, axis)
        if n % p:
            raise ValueError(f"catalog rows ({n}) must divide by the mesh's {axis} "
                             f"axis ({p})")
        if cfg.index is not None:
            if "ivf" in self._sharded_kwargs:
                import warnings

                warnings.warn("AcaiCache: sharded_kwargs['ivf'] overrides cfg.index — "
                              "drop one of them", DeprecationWarning, stacklevel=3)
            else:
                self.index = build_index(cfg.index, full, device=self.device, mesh=mesh)
                self._sharded_kwargs["ivf"] = self.index
        if self._sharded_kwargs.get("ivf") is not None:
            self._sharded_kwargs["ivf"] = self._sharded_kwargs["ivf"].to(self.device)
        self.catalog = dist_lib.block_of(full, mesh, axis).to(self.device).contiguous()
        self.valid = torch.ones(self.catalog.shape[0], dtype=torch.bool,
                                device=self.device)
        # the whole liveness mask on the host: every rank applies the same
        # mutations, so each validates and renumbers without an exchange
        self._valid_host = np.ones(n, dtype=bool)
        self._live = self._n_slots = n
        self.answer_cache = None
        if state is None:
            state = init_state(n, cfg, seed=seed, device=self.device)
        elif state.y.device != self.device or state.y.shape[0] != n:
            raise ValueError("state must lie on the cache's device and match the "
                             "catalog size (the whole state: it is cut here)")
        self.state = CacheState(dist_lib.block_of(state.y, mesh, axis).clone(),
                                dist_lib.block_of(state.x, mesh, axis).clone(),
                                state.t, state.gen)

    def _model_axis(self) -> str:
        return self._sharded_kwargs.get("model_axis", "model")

    def _mesh_model_size(self) -> int:
        from repro_torch.core.distributed import _axis_size

        return _axis_size(self.mesh, self._model_axis())

    def _block_lo(self) -> int:
        """This rank's first global row."""
        from repro_torch.core.distributed import _axis_rank

        return _axis_rank(self.mesh, self._model_axis()) * self.catalog.shape[0]

    def _batch_step(self, b: int) -> Callable:
        """The static step of batch b: the sharded one on a mesh, else the
        batched one over the candidate generator."""
        step = self._bsteps.get(b)
        if step is None:
            if self.mesh is not None:
                from repro_torch.core.distributed import make_step_sharded

                step = make_step_sharded(self.cfg, self.mesh, self.catalog, b,
                                         **self._sharded_kwargs)
            else:
                step = make_step_batched(self.cfg, self._fn_batched, b)
            self._bsteps[b] = step
        return step

    def attach_remote(self, remote=None, resilience=None):
        """Switch serving to the resilient mode: each request first runs
        its remote interaction (retries, hedging, deadline, circuit
        breaker) against `remote`, a `repro_torch.serve.remote` backend
        (None: the always-ok `OracleRemote`), and failed requests are
        served through the degradation ladder.  A batch whose every
        request succeeds takes the ordinary step, so a healthy backend
        leaves serving bitwise unchanged.  Returns the `AcaiResilience`
        controller (counters, breaker log, reports)."""
        from repro_torch.serve.resilience import AcaiResilience

        if self.mesh is not None:
            raise NotImplementedError(
                "resilient serving on a sharded mesh is not implemented yet — attach "
                "the remote to a single-device cache")
        self._res = AcaiResilience(self, remote, resilience)
        return self._res

    def serve_update(self, r: torch.Tensor, u=None) -> StepMetrics:
        """Serve one request (d,) and update: the B = 1 batched step."""
        m = self.serve_update_batch(torch.as_tensor(r)[None, :], u)
        return first_row(m)

    def serve_update_batch(self, rs, u=None) -> StepMetrics:
        """Serve a request mini-batch (B, d): one OMA + rounding update for
        the whole batch, per-request StepMetrics (B,).  `u` optionally
        injects the step's N rounding uniforms.  With a remote backend
        attached (`attach_remote`) the batch goes through the resilience
        ladder.  A batch given on the host keeps its host copy for the
        answer tier's keys.  The step's host time by phase and its waits on
        the card go to `self.spans` (`repro_torch.spans`); a batch that
        does not already lie on the cache's device is uploaded (the wait
        `upload`)."""
        with self.spans.step():
            host = host_rows(rs) if self.answer_cache is not None else None
            on_device = isinstance(rs, torch.Tensor) and rs.device == self.device
            with contextlib.nullcontext() if on_device else _UPLOAD:
                rs = torch.atleast_2d(torch.as_tensor(rs, dtype=torch.float32)).to(
                    self.device).contiguous()
            spans.batch(rs.shape[0])
            check_finite_queries(rs, "AcaiCache.serve_update_batch")
            if self._res is not None:
                return self._res.serve_update_batch(rs, u=u, host=host)
            return self._serve_batch_direct(rs, u=u, host=host)

    def _serve_batch_direct(self, rs: torch.Tensor, u=None, host=None) -> StepMetrics:
        """The fault-oblivious step on a (B, d) batch on the cache's device
        (also the all-ok path of the resilient mode, which keeps fault rate
        0 bitwise identical); `host` is its host copy, if any."""
        b = rs.shape[0]
        if self._mutated and self.mesh is not None:
            # candidates, OMA and the live-mask projection in the sharded
            # step; the slab block and its mask are arguments
            step = self._mut_steps.get(b)
            if step is None:
                from repro_torch.core.distributed import make_mutable_step_sharded

                kw = {k: v for k, v in self._sharded_kwargs.items()
                      if k in ("eta_scale", "model_axis", "batch_axes", "top_a")}
                step = self._mut_steps[b] = make_mutable_step_sharded(
                    self.cfg, self.mesh, b, **kw)
            self.state, metrics = step(self.state, rs, self.catalog, self.valid, u)
            return metrics
        if self._mutated:
            if self.answer_cache is not None:
                self.answer_cache.stage(host)
            ids, d, valid = self._mut_fn(rs, self.state.x)
            step = self._mut_steps.get(b)
            if step is None:
                step = self._mut_steps[b] = make_mutable_step(self.cfg, b)
            self.state, metrics = step(self.state, ids, d, valid, self.valid, u)
            if self.answer_cache is not None:
                metrics = metrics._replace(**self.answer_cache.step_counters(b))
            return metrics
        self.state, metrics = self._batch_step(b)(self.state, rs, u)
        return metrics

    # -- online catalog mutation ----------------------------------------------

    def _check_mutable_supported(self) -> None:
        """Reject mutation where the cache cannot serve it, before anything
        changes."""
        if not self._mutated and self.mesh is not None:
            if self.index is not None or self._sharded_kwargs.get("ivf") is not None:
                raise NotImplementedError(
                    "online catalog mutation on a sharded index backend is not "
                    "implemented — the sharded mutable path serves through the exact "
                    "masked scan; build the mesh cache with index=None")
            if self._sharded_kwargs.get("scan_chunk"):
                raise NotImplementedError(
                    "online catalog mutation on a sharded mesh serves through the "
                    "exact masked scan — drop sharded_kwargs['scan_chunk']")
        if not self._mutated and self._custom_fn:
            raise ValueError(
                "AcaiCache was built with an explicit candidate_fn*: the cache "
                "cannot rebuild a custom generator after catalog mutation — drop "
                "the escape hatch or rebuild the cache")

    def _enter_mutable(self) -> None:
        """Switch to the mutable serving step after the first mutation."""
        if self._mutated:
            return
        if self.mesh is not None:
            # the sharded mutable step generates its own candidates
            self._mutated = True
            return
        if self.index is not None:
            from repro_torch.index.candidates import mutable_index_candidate_fn

            self._mut_fn = mutable_index_candidate_fn(
                self.index, self.cfg.c_remote, self.cfg.c_local, h=self.cfg.h)
        else:
            def exact(rs, x):
                return exact_mutable_candidates(rs, x, self.catalog, self.valid,
                                                self.cfg.c_remote, self.cfg.c_local)

            self._mut_fn = exact
        self._mutated = True

    def _sync_capacity(self, new_ids: np.ndarray) -> None:
        """Grow y and x to the slab's (possibly doubled) capacity and admit
        the new rows at the uniform prior min(1, h / live) (Alg. 1's y_1 for
        the object; the next projection renormalises)."""
        cap = self.catalog.shape[0]
        y, x = self.state.y, self.state.x
        if y.shape[0] != cap:
            y, x = grow_rows(y, cap), grow_rows(x, cap)
        prior = min(1.0, self.cfg.h / max(self._live, 1))
        idx = torch.from_numpy(new_ids.astype(np.int64)).to(self.device)
        run_device(lambda t, i: t.index_fill_(0, i, prior), y, idx)
        self.state = CacheState(y, x, self.state.t, self.state.gen)

    def add_objects(self, vectors) -> np.ndarray:
        """Admit new catalog objects online: append them to the slab (and to
        the index's structures), grow the state, seed the new rows with the
        uniform prior.  Returns their ids (monotonic, never recycled)."""
        self._check_mutable_supported()
        vectors = torch.atleast_2d(torch.as_tensor(vectors, dtype=torch.float32)).to(
            self.device)
        if self.mesh is not None:
            return self._add_sharded(vectors)
        if self.index is not None:
            ids = self.index.add(vectors)
            self.catalog, self.valid = self.index.embeddings, self.index.valid
        else:
            self.catalog, self.valid, ids = slab_append(self.catalog, self.valid,
                                                        self._n_slots, vectors)
        self._n_slots += len(ids)
        self._live += len(ids)
        self._sync_capacity(ids)
        self._enter_mutable()
        return ids

    def _add_sharded(self, vectors: torch.Tensor) -> np.ndarray:
        """add_objects on a mesh: the append's runs written by their owners,
        y and x moved with the rows when the slab grows."""
        from repro_torch.core.distributed import sharded_slab_append

        self.catalog, self.valid, ids, (y, x) = sharded_slab_append(
            self.catalog, self.valid, self._n_slots, vectors, self.mesh,
            carry=(self.state.y, self.state.x), model_axis=self._model_axis())
        cap = self.catalog.shape[0] * self._mesh_model_size()
        if cap != self._valid_host.shape[0]:
            self._valid_host = np.concatenate(
                [self._valid_host, np.zeros(cap - self._valid_host.shape[0], bool)])
        self._valid_host[ids] = True
        self._n_slots += len(ids)
        self._live += len(ids)
        self.state = CacheState(y, x, self.state.t, self.state.gen)
        # the uniform prior on this rank's new rows
        lo = self._block_lo()
        mine = ids[(ids >= lo) & (ids < lo + self.catalog.shape[0])] - lo
        self._sync_capacity(mine)
        self._enter_mutable()
        return ids

    def _remove_sharded(self, ids) -> None:
        """remove_objects on a mesh: validated against the whole mask (the
        same on every rank), each owner tombstones its rows and zeroes
        their y and x."""
        from repro_torch.core.distributed import route_ids_by_owner

        ids = np.atleast_1d(np.asarray(ids, np.int32))
        if len(ids):
            if ids.min() < 0 or ids.max() >= self._n_slots:
                raise ValueError(f"remove_objects: ids must be assigned rows in "
                                 f"[0, {self._n_slots}); got range [{ids.min()}, "
                                 f"{ids.max()}]")
            if len(np.unique(ids)) != len(ids):
                raise ValueError("remove_objects: duplicate ids in one batch")
            alive = self._valid_host[ids]
            if not alive.all():
                raise ValueError(f"remove_objects: rows {ids[~alive].tolist()} are "
                                 f"already dead (tombstoned or never assigned)")
        self._valid_host[ids] = False
        self._live -= len(ids)
        self._enter_mutable()
        lo, block = self._block_lo(), self.catalog.shape[0]
        for p, gids in route_ids_by_owner(ids, self._valid_host.shape[0],
                                          self._mesh_model_size()):
            if p * block != lo:
                continue
            idx = torch.from_numpy((gids - lo).astype(np.int64)).to(self.device)
            run_device(lambda v, y, x, i: (v.index_fill_(0, i, False),
                                           y.index_fill_(0, i, 0.0),
                                           x.index_fill_(0, i, 0.0)),
                       self.valid, self.state.y, self.state.x, idx)

    def _compact_sharded(self) -> np.ndarray:
        """compact on a mesh: the live rows renumbered in ascending order
        over a capacity rounded up to a multiple of P, moved to their new
        owners with y and x by one gather (`regrid`)."""
        from repro_torch.core.distributed import regrid
        from repro_torch.index.base import MIN_WRITE, grow_capacity

        p = self._mesh_model_size()
        old_cap = self._valid_host.shape[0]
        live = np.nonzero(self._valid_host)[0]
        remap = np.full(old_cap, -1, np.int32)
        remap[live] = np.arange(live.shape[0], dtype=np.int32)
        cap = grow_capacity(0, live.shape[0] + MIN_WRITE, 1)
        cap += (-cap) % p
        self.catalog, y, x = regrid(
            [self.catalog, self.state.y, self.state.x], old_cap, cap, self.mesh,
            self._model_axis(), rows=torch.from_numpy(live).to(self.device))
        self._valid_host = np.arange(cap) < live.shape[0]
        lo = self._block_lo()
        self.valid = torch.from_numpy(
            self._valid_host[lo:lo + self.catalog.shape[0]].copy()).to(self.device)
        self._n_slots = self._live
        self.state = CacheState(y, x, self.state.t, self.state.gen)
        self._enter_mutable()
        return remap

    def remove_objects(self, ids) -> None:
        """Drop catalog objects online: tombstone them and zero their y and
        x (a removed object is never served nor fetched, and frees its
        slot at once; the mutable step keeps the rows at zero)."""
        self._check_mutable_supported()
        if self.mesh is not None:
            return self._remove_sharded(ids)
        if self.index is not None:
            self.index.remove(ids)
            ids = np.atleast_1d(np.asarray(ids, np.int32))
            self.valid = self.index.valid
        else:
            ids = check_removable(ids, self._n_slots, self.valid, "remove_objects")
            if len(ids):
                idx = torch.from_numpy(ids.astype(np.int64)).to(self.device)
                run_device(lambda v, i: v.index_fill_(0, i, False), self.valid, idx)
        self._live -= len(ids)
        self._enter_mutable()
        idx = torch.from_numpy(ids.astype(np.int64)).to(self.device)
        run_device(lambda y, x, i: (y.index_fill_(0, i, 0.0), x.index_fill_(0, i, 0.0)),
                   self.state.y, self.state.x, idx)

    def refresh(self) -> None:
        """Rebuild the index's structures over the live rows (a no-op for
        exact candidates, whose masked scan never drifts)."""
        if self.index is not None and self._mutated:
            self.index.refresh()

    def refresh_start(self) -> None:
        """Phase 1 of the two-phase refresh: the shadow rebuild."""
        if self.index is not None and self._mutated:
            self.index.refresh_start()

    def refresh_swap(self) -> None:
        """Phase 2: install the shadow (the only serving-visible stall)."""
        if self.index is not None and self._mutated:
            self.index.refresh_swap()

    def compact(self) -> np.ndarray:
        """Epoch compaction: drop the tombstoned rows, shrink the slab to the
        live rows (`compact_rows`' capacity), renumber them in ascending
        order; y and x move with their rows.  Returns the (old capacity,)
        int32 remap (new id, -1 for dead rows) for every other id holder."""
        self._check_mutable_supported()
        if self.mesh is not None:
            return self._compact_sharded()
        live, remap = live_remap(self.valid)
        if self.index is not None:
            remap = self.index.compact()
            self.catalog, self.valid = self.index.embeddings, self.index.valid
        else:
            self.catalog, self.valid = compact_rows(self.catalog, live)
        self._n_slots = self._live
        cap, n_live = self.catalog.shape[0], live.shape[0]
        # the remap keeps the order, so the live rows move to [0, n_live)
        y = torch.zeros(cap, dtype=self.state.y.dtype, device=self.device)
        x = torch.zeros(cap, dtype=self.state.x.dtype, device=self.device)
        y[:n_live], x[:n_live] = self.state.y[live], self.state.x[live]
        self.state = CacheState(y, x, self.state.t, self.state.gen)
        self._enter_mutable()
        return remap

    @property
    def live_count(self) -> int:
        """Live (non-tombstoned) catalog objects."""
        return self._live

    @property
    def cached_ids(self) -> torch.Tensor:
        """The cached objects' ids (on a mesh, this rank's, as global ids)."""
        ids = torch.nonzero(self.state.x > 0.5).flatten()
        return ids if self.mesh is None else ids + self._block_lo()

    def normalized_gain(self, total_gain: float, t: int) -> float:
        """NAG of Eq. (11)."""
        return float(total_gain) / (self.cfg.k * self.cfg.c_f * max(t, 1))
