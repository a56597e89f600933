"""AÇAI policy: request serving + OMA cache updates (paper Sec. IV).

Port of `repro.core.policy`, static catalog.  The batched step serves a
mini-batch of requests against the same cache state: candidate generation
from the remote index plus a scan of the cached rows, serving by Eq. (2),
gain and subgradient by Eq. (55), one averaged OMA step with the
capped-simplex projection, then rounding.  A replay is a Python loop of
steps where the reference scans.

Randomness: the reference splits a `jax.random` key per step for the
rounding.  Here the state carries a `torch.Generator`, and every step also
accepts its uniforms explicitly, so a test can feed it the numbers the
reference drew from its own keys.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core import gain as gain_lib
from repro_torch.core import oma as oma_lib
from repro_torch.core import rounding as rounding_lib
from repro_torch.core.costs import BIG_COST, pairwise_dissimilarity
from repro_torch.index.base import build_index, check_finite_queries, resolve_spec
from repro_torch.kernels.ref import smallest_k


class StepMetrics(NamedTuple):
    gain_int: torch.Tensor      # G(r_t, x_t) — what the system earns
    gain_frac: torch.Tensor     # G(r_t, y_t) — fractional gain (analysis)
    cost: torch.Tensor          # C(r_t, x_t)
    served_local: torch.Tensor  # answers served from the cache
    fetched: torch.Tensor       # cache-update traffic (objects fetched)
    occupancy: torch.Tensor     # sum x_{t+1}


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


def exact_candidate_fn_batched(catalog: torch.Tensor, c_remote: int,
                               c_local: int, metric: str = "sqeuclidean") -> Callable:
    """Batched candidate generator backed by exact search on both sides:
    fn(rs (B, d), x (N,)) -> (ids, d, valid), each (B, C).  One (B, N)
    distance matrix from the `pairwise_l2` kernel feeds both the remote
    top-k and the cached-row top-k."""
    n = catalog.shape[0]

    def fn(rs: torch.Tensor, x: torch.Tensor):
        b = rs.shape[0]
        d_full = pairwise_dissimilarity(rs.contiguous(), catalog, metric)  # (B, N)
        ids_remote = smallest_k(d_full, c_remote)[1]
        cached = x[None, :] > 0.5
        d_cached = torch.where(cached, d_full, torch.full_like(d_full, float("inf")))
        ids_local = smallest_k(d_cached, c_local)[1]
        ids = torch.cat([ids_remote, ids_local], dim=1)
        valid = dedup_mask_batched(ids, n)
        # a "local" candidate slot is only valid if that object is cached
        cached_ok = torch.cat([torch.ones((b, c_remote), dtype=torch.bool,
                                          device=x.device),
                               x[ids_local] > 0.5], dim=1)
        valid = valid & cached_ok
        d = torch.where(valid, torch.gather(d_full, 1, torch.clamp(ids, 0, n - 1)),
                        torch.full(ids.shape, BIG_COST, device=x.device))
        return ids, d, valid

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


def apply_candidates_batched(cfg: AcaiConfig, cfg_up: AcaiConfig,
                             state: CacheState, batch: int, ids, d, valid, u=None):
    """Serve + update tail of a mini-batch step on a candidate slab
    (ids, d, valid) of shape (B, C).  `u` holds the step's N rounding
    uniforms (drawn from the state's generator when None)."""
    n = state.y.shape[0]
    ids_c = torch.clamp_max(ids, n - 1)
    zero = torch.zeros((), dtype=state.y.dtype, device=state.y.device)
    x_cand = torch.where(valid, state.x[ids_c], zero)
    y_cand = torch.where(valid, state.y[ids_c], zero)

    served = gain_lib.serve_batch(d, x_cand, cfg.k, cfg.c_f)
    gain_frac, g_cand = gain_lib.gain_and_subgradient_batch(d, y_cand, cfg.k, cfg.c_f)

    # the reference's .at[].add scatter; on CUDA index_add_ sums the
    # duplicates of a batch with atomics, in an order that changes from
    # run to run, so g_full (and y) agree to float tolerance only
    g_full = torch.zeros_like(state.y).index_add_(
        0, ids_c.reshape(-1), torch.where(valid, g_cand, zero).reshape(-1) / batch)
    y_new = oma_lib.oma_update(state.y, g_full, cfg.h, cfg_up.oma)
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
    return StepMetrics(*(torch.cat(f) for f in zip(*ms)))


def make_replay_batched(cfg: AcaiConfig, candidate_fn_batched: Callable, batch: int,
                        eta_scale: float | None = None) -> Callable:
    """Whole-trace replay: (state, requests (T, d), uniforms=None) ->
    (state', StepMetrics (T,)).  T must divide by `batch`; `uniforms`, when
    given, holds one row of rounding uniforms per step, (T / batch, N)."""
    step = make_step_batched(cfg, candidate_fn_batched, batch, eta_scale)

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


def make_step(cfg: AcaiConfig, candidate_fn_batched: Callable) -> Callable:
    """Per-request step: (state, r (d,), u=None) -> (state', StepMetrics of
    scalars) — the B = 1 view of the batched step (eta unscaled)."""
    step = make_step_batched(cfg, candidate_fn_batched, 1)

    def step1(state: CacheState, r: torch.Tensor, u=None):
        state, m = step(state, r[None, :], u)
        return state, StepMetrics(*(f[0] for f in m))

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


class AcaiCache:
    """Object API over the batched step, for a serving tier: requests
    arrive one by one (`serve_update`) or in batches (`serve_update_batch`).

    The remote-catalog index comes from `cfg.index`: an IndexSpec builds
    it through the registry and wires it in with
    `index_candidate_fn_batched`; None gives exact candidates.  Static
    catalog only: the mesh, remote-backend, answer-cache and mutation
    surfaces of the reference raise NotImplementedError naming the
    ROADMAP item that ports them.  `state` starts the cache from a given
    CacheState (it must lie on `device`) instead of running `init_state`."""

    def __init__(self, catalog, cfg: AcaiConfig, seed: int = 0, device=None,
                 state: CacheState | None = None, mesh=None, remote=None,
                 resilience=None, answer_cache=None):
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
            raise TypeError(f"AcaiCache takes an AcaiConfig, got {type(cfg)} "
                            f"({_NOT_PORTED.format(item=6, what='PolicySpec forms')})")
        resolved = resolve_spec(cfg.index)
        if resolved is not cfg.index:
            cfg = dataclasses.replace(cfg, index=resolved)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.catalog = torch.as_tensor(catalog, dtype=torch.float32).to(
            self.device).contiguous()
        n = self.catalog.shape[0]
        if cfg.index is not None:
            from repro_torch.index.candidates import index_candidate_fn_batched

            self.index = build_index(cfg.index, self.catalog, device=self.device)
            self._fn_batched = index_candidate_fn_batched(
                self.index, self.catalog, cfg.c_remote, cfg.c_local, h=cfg.h)
        else:
            self.index = None
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
        m = self.serve_update_batch(r[None, :], u)
        return StepMetrics(*(f[0] for f in m))

    def serve_update_batch(self, rs: torch.Tensor, u=None) -> StepMetrics:
        """Serve a request mini-batch (B, d): one OMA + rounding update for
        the whole batch, per-request StepMetrics (B,).  `u` optionally
        injects the step's N rounding uniforms."""
        rs = torch.atleast_2d(torch.as_tensor(rs, dtype=torch.float32)).to(self.device)
        check_finite_queries(rs, "AcaiCache.serve_update_batch")
        b = rs.shape[0]
        step = self._bsteps.get(b)
        if step is None:
            step = make_step_batched(self.cfg, self._fn_batched, b)
            self._bsteps[b] = step
        self.state, metrics = step(self.state, rs.contiguous(), u)
        return metrics

    def _mutation(self, *_args, **_kw):
        raise NotImplementedError(_NOT_PORTED.format(
            item=8, what="online catalog mutation"))

    add_objects = remove_objects = refresh = refresh_start = refresh_swap = \
        compact = _mutation

    def attach_remote(self, *_args, **_kw):
        raise NotImplementedError(_NOT_PORTED.format(
            item=9, what="resilient serving against a remote backend"))

    @property
    def cached_ids(self) -> torch.Tensor:
        return torch.nonzero(self.state.x > 0.5).flatten()

    def normalized_gain(self, total_gain: float, t: int) -> float:
        """NAG of Eq. (11)."""
        return float(total_gain) / (self.cfg.k * self.cfg.c_f * max(t, 1))
