"""Randomised rounding: DepRound (Byrka et al.) and CoupledRounding (App. F).

Port of `repro.core.rounding`.  Where the reference draws its uniforms
from a `jax.random` key inside each function, every rounding here takes
its uniforms as an explicit tensor argument: the two frameworks' random
streams differ, so tests draw the uniforms from the reference's keys and
hand the same numbers to both.
"""

from __future__ import annotations

import numpy as np
import torch

_DELTA = 1e-9


def depround(u, y: torch.Tensor) -> torch.Tensor:
    """DepRound: y in [0,1]^N with integral sum h -> x in {0,1}^N, sum x = h.

    `u` holds at least N - 1 uniforms in [0, 1) (the first N - 1 are
    used).  The pairwise walk is serial, so it runs on the host in
    float32 numpy scalars — the reference runs in float32 too (x64 off),
    and Python floats would round differently.  One SIMPLIFY step per
    coordinate: carry one fractional "active" coordinate, freeze whichever
    of the pair becomes integral."""
    n = y.shape[0]
    yf = y.detach().to("cpu", torch.float32).numpy()
    us = (u.detach().to("cpu", torch.float32).numpy() if isinstance(u, torch.Tensor)
          else np.asarray(u, np.float32))[:n - 1]
    f32 = np.float32
    one, delta = f32(1.0), f32(_DELTA)
    lo, hi = f32(_DELTA * 10), f32(1.0 - _DELTA * 10)
    x = np.zeros(n, np.float32)  # frozen values, rounded once at the end
    aidx, p = 0, yf[0]           # the active coordinate and its value
    # lists of numpy float32 scalars: every operation below rounds to
    # float32, and iterating a list is the cheapest walk (~1 s at N = 1M)
    for i, q, ui in zip(range(1, n), list(yf[1:]), list(us)):
        omp, omq = one - p, one - q
        alpha = omp if omp < q else q
        beta = p if p < omq else omq
        denom = alpha + beta
        if denom <= delta:  # both already integral
            p1, q1 = p, q
        elif ui * denom < beta:  # denom > delta here: max(denom, delta) = denom
            p1, q1 = p + alpha, q - alpha
        else:
            p1, q1 = p - beta, q + beta
        if p1 <= lo or p1 >= hi:
            x[aidx] = p1
            aidx, p = i, q1
        else:
            x[i] = q1
            p = p1
    x[aidx] = p
    return torch.from_numpy(np.round(x)).to(device=y.device, dtype=y.dtype)


def coupled_rounding(u: torch.Tensor, x_t: torch.Tensor, y_t: torch.Tensor,
                     y_tp1: torch.Tensor) -> torch.Tensor:
    """Algorithm 2: component-wise coupled rounding (u: N uniforms)."""
    delta = y_tp1 - y_t
    p_evict = -delta / torch.clamp_min(y_t, _DELTA)
    p_fetch = delta / torch.clamp_min(1.0 - y_t, _DELTA)
    evict = (x_t > 0.5) & (delta < 0) & (u < p_evict)
    fetch = (x_t < 0.5) & (delta > 0) & (u < p_fetch)
    out = torch.where(fetch, torch.ones_like(x_t), x_t)
    return torch.where(evict, torch.zeros_like(x_t), out)


def independent_rounding(u: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Relaxed-capacity rounding (App. F): x_i = 1{u_i < y_i}, i.e.
    Bernoulli(y_i) independently (u: N uniforms)."""
    return (u < y).to(y.dtype)


def movement(x_new: torch.Tensor, x_old: torch.Tensor) -> torch.Tensor:
    """Number of fetches |{i: x goes 0->1}| — the update cost of App. F."""
    return torch.sum(torch.clamp_min(x_new - x_old, 0.0))
