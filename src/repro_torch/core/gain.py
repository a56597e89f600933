"""Caching gain, service cost and subgradients (paper Sec. IV-D, App. B/C).

Port of `repro.core.gain`.  Every candidate slot i of a request
contributes two augmented entries: its local copy (cost d_i, weight y_i)
and its remote copy (cost d_i + c_f, weight 1 - y_i).  Invalid slots carry
d_i = BIG_COST and y_i = 0, so they sort to the tail and stay neutral.

The batched forms are the primary ones here (a batch dimension written
out where the reference vmaps); the single-request forms are their B = 1
view.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AugmentedOrder(NamedTuple):
    """Sorted augmented-entry view of a candidate batch (B, 2C)."""

    costs: torch.Tensor          # (B, 2C) sorted ascending
    weights: torch.Tensor        # (B, 2C)
    is_remote: torch.Tensor      # (B, 2C) bool
    cand_of_entry: torch.Tensor  # (B, 2C) candidate slot of each entry
    lpos: torch.Tensor           # (B, C) sorted position of the local copy
    rpos: torch.Tensor           # (B, C) sorted position of the remote copy


def _augment_and_sort(d: torch.Tensor, y: torch.Tensor, c_f) -> AugmentedOrder:
    b, c = d.shape
    costs = torch.cat([d, d + c_f], dim=1)
    weights = torch.cat([y, 1.0 - y], dim=1)
    is_remote = torch.zeros((b, 2 * c), dtype=torch.bool, device=d.device)
    is_remote[:, c:] = True
    # stable: invalid slots all carry BIG_COST, and their tie order
    # decides lpos / rpos exactly as jnp.argsort(stable=True) does
    order = torch.sort(costs, dim=1, stable=True).indices
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(2 * c, device=d.device).expand(b, -1))
    return AugmentedOrder(
        costs=torch.gather(costs, 1, order),
        weights=torch.gather(weights, 1, order),
        is_remote=torch.gather(is_remote, 1, order),
        cand_of_entry=torch.where(order < c, order, order - c),
        lpos=inv[:, :c],
        rpos=inv[:, c:],
    )


def _prefix_terms(a: AugmentedOrder, k: int, dtype):
    s = torch.cumsum(a.weights, dim=1)                 # S_i
    sig = torch.cumsum(a.is_remote.to(dtype), dim=1)   # sigma_i
    alpha = a.costs[:, 1:] - a.costs[:, :-1]           # c_{i+1} - c_i
    active = sig[:, :-1] < k
    inner = torch.minimum(k - sig[:, :-1], s[:, :-1] - sig[:, :-1])
    gain = torch.sum(torch.where(active, alpha * inner,
                                 torch.zeros_like(alpha)), dim=1)
    return s, gain


def gain_value_batch(d: torch.Tensor, y: torch.Tensor, k: int, c_f) -> torch.Tensor:
    """Caching gain G(r, y) of Eq. (7) per request: d, y (B, C) -> (B,)."""
    return _prefix_terms(_augment_and_sort(d, y, c_f), k, d.dtype)[1]


def gain_and_subgradient_batch(d: torch.Tensor, y: torch.Tensor, k: int, c_f):
    """G(r, y) (B,) and a subgradient g (B, C) of Eq. (55), App. C.

    g_l = c(r, pi_{b_l + 1}) - d_l if lpos_l <= b_l else 0, with
    b_l = min(rpos_l - 1, T) and T = max{i : S_i < k}."""
    a = _augment_and_sort(d, y, c_f)
    s, gain = _prefix_terms(a, k, d.dtype)
    two_c = a.costs.shape[1]
    t = torch.sum(s < k, dim=1, keepdim=True) - 1      # -1 if none
    b = torch.minimum(a.rpos - 1, t)
    upper = torch.gather(a.costs, 1, torch.clamp(b + 1, 0, two_c - 1))
    g = torch.where(a.lpos <= b, upper - d, torch.zeros_like(d))
    return gain, torch.clamp_min(g, 0.0)  # alpha_i >= 0; guards float dust


class ServeResult(NamedTuple):
    answer_ids: torch.Tensor    # (B, k) candidate-slot indices of the answer
    from_cache: torch.Tensor    # (B, k) bool — served locally?
    answer_costs: torch.Tensor  # (B, k) per-object cost c(r, .)
    cost: torch.Tensor          # (B,) C(r, x), Eq. (5)
    gain: torch.Tensor          # (B,) G(r, x), Eq. (6)


def serve_batch(d: torch.Tensor, x: torch.Tensor, k: int, c_f) -> ServeResult:
    """Compose each answer per Eq. (2): the first k available augmented
    entries (weight 1) in cost order.  x: (B, C) integral indicator."""
    a = _augment_and_sort(d, x, c_f)
    two_c = a.costs.shape[1]
    w = a.weights > 0.5
    rank = torch.cumsum(w.to(torch.int32), dim=1)
    chosen = w & (rank <= k)
    cost = torch.sum(torch.where(chosen, a.costs, torch.zeros_like(a.costs)),
                     dim=1)

    # nonzero(chosen, size=k, fill_value=2C-1), padded by hand: a stable
    # sort on "not chosen" lists the chosen positions first, ascending
    first = torch.sort((~chosen).to(torch.int8), dim=1, stable=True).indices[:, :k]
    n_chosen = chosen.sum(dim=1, keepdim=True)
    slot = torch.arange(k, device=d.device)[None, :]
    pos = torch.where(slot < n_chosen, first, torch.full_like(first, two_c - 1))
    answer_ids = torch.gather(a.cand_of_entry, 1, pos)
    from_cache = ~torch.gather(a.is_remote, 1, pos)
    answer_costs = torch.gather(a.costs, 1, pos)

    # empty-cache cost: the k closest candidates, all fetched remotely;
    # maximum() guards the float dust of the two summation orders
    empty_cost = empty_cache_cost_batch(d, k, c_f)
    return ServeResult(answer_ids, from_cache, answer_costs, cost,
                       torch.clamp_min(empty_cost - cost, 0.0))


def empty_cache_cost_batch(d: torch.Tensor, k: int, c_f) -> torch.Tensor:
    """C(r, (0..0,1..1)) per request: all k answers fetched from the server."""
    top = torch.topk(d, k, dim=1, largest=False, sorted=True).values
    return torch.sum(top, dim=1) + k * c_f


def empty_cache_cost(d: torch.Tensor, k: int, c_f) -> torch.Tensor:
    """C(r, (0..0,1..1)) of one request: all k answers fetched from the
    server."""
    return empty_cache_cost_batch(d[None], k, c_f)[0]


def lower_bound_l(d: torch.Tensor, y: torch.Tensor, k: int, c_f) -> torch.Tensor:
    """The multilinear lower bound L(r, y) of Eq. (15) (App. A) of one
    request, d, y (C,) -> scalar:

    L(r, y) = sum_i alpha_i (k - sigma_i) (1 - prod_{j in I_i} (1 - y_pi_j / (k - sigma_i)))

    where I_i keeps the local copies in the prefix whose remote twin is
    not in it.  Lemma 1: L(y) <= G(y) <= (1 - 1/e)^{-1} L(y).  A check of
    the bound, O(C^2), not on any serving path."""
    a = _augment_and_sort(d[None], y[None], c_f)
    costs, weights, is_remote = a.costs[0], a.weights[0], a.is_remote[0]
    two_c = costs.shape[0]
    sig = torch.cumsum(is_remote.to(d.dtype), dim=0)
    alpha = costs[1:] - costs[:-1]
    active = sig[:-1] < k
    pos = torch.arange(two_c, device=d.device)
    local = ~is_remote
    rpos_of_entry = a.rpos[0][a.cand_of_entry[0]]       # each entry's remote twin
    yv = torch.where(local, weights, torch.zeros_like(weights))
    i = pos[:-1, None]                                   # prefix i, entry p
    member = (pos[None, :] <= i) & local[None, :] & (rpos_of_entry[None, :] > i)
    c = torch.clamp_min(k - sig[:-1], 1.0)[:, None]
    prod = torch.prod(torch.where(member, 1.0 - yv[None, :] / c, torch.ones_like(c)), dim=1)
    terms = (k - sig[:-1]) * (1.0 - prod)
    return torch.sum(torch.where(active, alpha * terms, torch.zeros_like(alpha)))


def gain_value(d: torch.Tensor, y: torch.Tensor, k: int, c_f) -> torch.Tensor:
    """Single-request G(r, y): d, y (C,) -> scalar."""
    return gain_value_batch(d[None], y[None], k, c_f)[0]


def gain_and_subgradient(d: torch.Tensor, y: torch.Tensor, k: int, c_f):
    """Single-request (G(r, y), g (C,))."""
    gain, g = gain_and_subgradient_batch(d[None], y[None], k, c_f)
    return gain[0], g[0]


def serve(d: torch.Tensor, x: torch.Tensor, k: int, c_f) -> ServeResult:
    """Single-request serve: every field loses its batch dimension."""
    return ServeResult(*(f[0] for f in serve_batch(d[None], x[None], k, c_f)))
