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

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import gain as gain_lib
from repro_torch.core import oma as oma_lib
from repro_torch.core import rounding as rounding_lib
from repro_torch.core.costs import BIG_COST, pairwise_dissimilarity
from repro_torch.index.base import (build_index, check_finite_queries, check_removable,
                                    compact_rows, grow_rows, live_remap, resolve_spec,
                                    run_device, slab_append)
from repro_torch.kernels.ref import smallest_k


class StepMetrics(NamedTuple):
    gain_int: torch.Tensor      # G(r_t, x_t) — what the system earns
    gain_frac: torch.Tensor     # G(r_t, y_t) — fractional gain (analysis)
    cost: torch.Tensor          # C(r_t, x_t)
    served_local: torch.Tensor  # answers served from the cache
    fetched: torch.Tensor       # cache-update traffic (objects fetched)
    occupancy: torch.Tensor     # sum x_{t+1}
    # the reference's debug counter (cached rows past the candidate
    # generator's gather) and its resilient-serving and answer-tier
    # counters: 0 on every path ported so far (the AÇAI step leaves the
    # int default; the baselines fill them with zero arrays)
    local_overflow: torch.Tensor | int = 0
    degraded: torch.Tensor | int = 0
    shed: torch.Tensor | int = 0
    remote_failures: torch.Tensor | int = 0
    retries: torch.Tensor | int = 0
    deadline_misses: torch.Tensor | int = 0
    answer_hits: torch.Tensor | int = 0
    answer_misses: torch.Tensor | int = 0
    answer_invalidations: torch.Tensor | int = 0


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
    ids_c = torch.clamp_max(ids, n - 1)
    zero = torch.zeros((), dtype=state.y.dtype, device=state.y.device)
    x_cand = torch.where(valid, state.x[ids_c], zero)
    y_cand = torch.where(valid, state.y[ids_c], zero)

    served = gain_lib.serve_batch(d, x_cand, cfg.k, cfg.c_f)
    gain_frac, g_cand = gain_lib.gain_and_subgradient_batch(d, y_cand, cfg.k, cfg.c_f)

    # the reference's .at[].add scatter, in a fixed order (scatter_rows_sum)
    g_full = scatter_rows_sum(n, ids_c, g_cand / batch, valid)
    y_new = oma_lib.oma_update(state.y, g_full, cfg.h, cfg_up.oma)
    if alive is not None:
        y_new = torch.where(alive, y_new, zero)
    if u is None:
        u = draw_uniforms(state)
    return finish_step_batched(
        cfg_up, state, u, batch, y_new, served.gain, gain_frac, served.cost,
        torch.sum(served.from_cache.to(torch.int32), dim=1))


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


_NOT_PORTED = "not ported yet (ROADMAP A{item}: {what})"


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
    online (`add_objects`, `remove_objects`, `refresh*`, `compact`); the
    mesh, remote-backend and answer-cache surfaces of the reference raise
    NotImplementedError naming the ROADMAP item that ports them.  `state`
    starts the cache from a given CacheState (it must lie on `device`)
    instead of running `init_state`."""

    def __init__(self, catalog, cfg, seed: int = 0, device=None,
                 state: CacheState | None = None, mesh=None, remote=None,
                 resilience=None, answer_cache=None, candidate_fn=None,
                 candidate_fn_batched=None, c_f: float | None = None):
        if mesh is not None:
            raise NotImplementedError(_NOT_PORTED.format(
                item=11, what="the sharded step over a mesh"))
        if remote is not None or resilience is not None:
            raise NotImplementedError(_NOT_PORTED.format(
                item=9, what="resilient serving against a remote backend"))
        if answer_cache is not None:
            raise NotImplementedError(_NOT_PORTED.format(
                item=9, what="the answer-cache tier"))
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
        self.device = resolve_device(device)
        self.catalog = torch.as_tensor(catalog, dtype=torch.float32).to(
            self.device).contiguous()
        n = self.catalog.shape[0]
        self.index = None  # the spec-built index (None: exact or escape hatch)
        # mutable-catalog bookkeeping: the cache serves the static step
        # until the first mutation, then the mutable one (make_mutable_step)
        self.valid = torch.ones(n, dtype=torch.bool, device=self.device)
        self._live = self._n_slots = n
        self._mutated = False
        self._mut_fn: Callable | None = None
        self._mut_steps: dict[int, Callable] = {}
        explicit = candidate_fn is not None or candidate_fn_batched is not None
        self._custom_fn = explicit
        if explicit and cfg.index is not None:
            import warnings

            warnings.warn("AcaiCache: cfg.index is set but explicit candidate_fn/"
                          "candidate_fn_batched overrides it — drop the kwargs or "
                          "the spec", DeprecationWarning, stacklevel=2)
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
        self._bsteps: dict[int, Callable] = {}
        if state is None:
            state = init_state(n, cfg, seed=seed, device=self.device)
        elif state.y.device != self.device or state.y.shape[0] != n:
            raise ValueError("state must lie on the cache's device and match "
                             "the catalog size")
        self.state = state

    def serve_update(self, r: torch.Tensor, u=None) -> StepMetrics:
        """Serve one request (d,) and update: the B = 1 batched step."""
        m = self.serve_update_batch(torch.as_tensor(r)[None, :], u)
        return first_row(m)

    def serve_update_batch(self, rs: torch.Tensor, u=None) -> StepMetrics:
        """Serve a request mini-batch (B, d): one OMA + rounding update for
        the whole batch, per-request StepMetrics (B,).  `u` optionally
        injects the step's N rounding uniforms."""
        rs = torch.atleast_2d(torch.as_tensor(rs, dtype=torch.float32)).to(
            self.device).contiguous()
        check_finite_queries(rs, "AcaiCache.serve_update_batch")
        b = rs.shape[0]
        if self._mutated:
            ids, d, valid = self._mut_fn(rs, self.state.x)
            step = self._mut_steps.get(b)
            if step is None:
                step = self._mut_steps[b] = make_mutable_step(self.cfg, b)
            self.state, metrics = step(self.state, ids, d, valid, self.valid, u)
            return metrics
        step = self._bsteps.get(b)
        if step is None:
            step = make_step_batched(self.cfg, self._fn_batched, b)
            self._bsteps[b] = step
        self.state, metrics = step(self.state, rs, u)
        return metrics

    # -- online catalog mutation ----------------------------------------------

    def _check_mutable_supported(self) -> None:
        """Reject mutation where the cache cannot serve it, before anything
        changes (a mesh never gets this far: the constructor raises, A11)."""
        if not self._mutated and self._custom_fn:
            raise ValueError(
                "AcaiCache was built with an explicit candidate_fn*: the cache "
                "cannot rebuild a custom generator after catalog mutation — drop "
                "the escape hatch or rebuild the cache")

    def _enter_mutable(self) -> None:
        """Switch to the mutable serving step after the first mutation."""
        if self._mutated:
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

    def remove_objects(self, ids) -> None:
        """Drop catalog objects online: tombstone them and zero their y and
        x (a removed object is never served nor fetched, and frees its
        slot at once; the mutable step keeps the rows at zero)."""
        self._check_mutable_supported()
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

    def attach_remote(self, *_args, **_kw):
        raise NotImplementedError(_NOT_PORTED.format(
            item=9, what="resilient serving against a remote backend"))

    @property
    def cached_ids(self) -> torch.Tensor:
        return torch.nonzero(self.state.x > 0.5).flatten()

    def normalized_gain(self, total_gain: float, t: int) -> float:
        """NAG of Eq. (11)."""
        return float(total_gain) / (self.cfg.k * self.cfg.c_f * max(t, 1))
