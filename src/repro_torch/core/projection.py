"""Bregman projections onto the capped simplex (paper Sec. IV-F, line 6 Alg. 1).

B_h = { y in [0,1]^N : sum_i y_i = h }.  The negentropy projection is
y_i = min(1, s z_i) with the unique s > 0 that meets the sum, found
exactly by a sort-based threshold scan; the Euclidean one is
clip(z - tau, 0, 1) with tau found by bisection.  Port of
`repro.core.projection`.
"""

from __future__ import annotations

import torch

_TINY = 1e-30
_SCAN_ROW = 1024  # the row width of `suffix_sum`'s two-level scan


def suffix_sum(v: torch.Tensor) -> torch.Tensor:
    """Suffix sums of a 1-D tensor, `out[i] = sum(v[i:])`, added from the
    end (the small tail entries of a descending vector first), in an order
    fixed by the length alone.

    PyTorch scans a tensor whose every element lies on the scanned
    dimension with CUB's decoupled look-back on CUDA, which takes a tile's
    prefix from its predecessors' partial sums in whatever order they come
    ready, so two runs may differ in the last bit.  Here the reversed
    vector is laid out as rows of `_SCAN_ROW` (at least two rows), each row
    scanned on its own, and the rows' totals scanned as a row beside a row
    of zeros: PyTorch scans those along the last dimension block by block,
    in a fixed order."""
    n = v.shape[0]
    rows = max(2, -(-n // _SCAN_ROW))
    w = torch.nn.functional.pad(torch.flip(v, (0,)), (0, rows * _SCAN_ROW - n))
    within = torch.cumsum(w.reshape(rows, _SCAN_ROW), dim=1)
    totals = within[:-1, -1]
    # each row's offset: the totals of the rows before it
    before = torch.cumsum(torch.stack([totals, torch.zeros_like(totals)]), dim=1)[0]
    before = torch.cat([torch.zeros_like(before[:1]), before])
    return torch.flip((within + before[:, None]).reshape(-1)[:n], (0,))


def _negentropy_scale_from_sorted(zs_desc: torch.Tensor, tail_sum, h):
    """Find s with sum min(1, s z) = h given the (descending) head
    `zs_desc` of z plus the scalar sum of the remaining (never-capped)
    tail.  Returns (s, whether any split was feasible)."""
    a = zs_desc.shape[0]
    m = torch.arange(a, dtype=zs_desc.dtype, device=zs_desc.device)
    # reversed cumsum: accumulates the small tail entries first — avoids
    # the float32 cancellation of the (total - prefix) formulation — in a
    # fixed order, so two runs on the card agree to the last bit
    suffix = suffix_sum(zs_desc)
    denom = torch.clamp_min(suffix + tail_sum, _TINY)
    s_m = (h - m) / denom
    # consistency: first uncapped scaled <= 1, last capped scaled >= 1
    cond_uncapped = zs_desc * s_m <= 1.0 + 1e-7
    prev = torch.cat([torch.full((1,), float("inf"), dtype=zs_desc.dtype,
                                 device=zs_desc.device), zs_desc[:-1]])
    cond_capped = prev * s_m >= 1.0 - 1e-7
    valid = cond_uncapped & cond_capped & (h - m > 0)
    # torch.argmax on an int cast returns the first maximum, like
    # jnp.argmax: the smallest feasible m
    idx = torch.argmax(valid.to(torch.int32))
    # a gather, not s_m[idx]: indexing by a 0-d tensor reads it back
    return s_m.index_select(0, idx.reshape(1))[0], valid.any()


def capped_simplex_negentropy(z: torch.Tensor, h) -> torch.Tensor:
    """Exact sort-based negentropy Bregman projection, O(N log N)."""
    n = z.shape[0]
    z = torch.clamp_min(z, 0.0)
    zs = torch.sort(z, descending=True).values
    s, _ = _negentropy_scale_from_sorted(zs, torch.zeros((), dtype=z.dtype,
                                                         device=z.device), h)
    y = torch.clamp_max(z * s, 1.0)
    # h >= N degenerate: everything capped
    return torch.ones_like(z) if h >= n else y


def capped_simplex_negentropy_topk(z: torch.Tensor, h, a: int) -> torch.Tensor:
    """O(N + A log A) variant: sort only the top-A entries (A >= h + slack)."""
    z = torch.clamp_min(z, 0.0)
    ztop, idx = torch.topk(z, a, sorted=True)
    # sum the non-top tail directly (no total-minus-top cancellation)
    tail = torch.sum(z.index_fill(0, idx, 0.0))
    s, ok = _negentropy_scale_from_sorted(ztop, tail, h)
    # degenerate z can leave no feasible water level; fall back to scale 1
    s = torch.where(ok, s, torch.ones_like(s))
    return torch.clamp_max(z * s, 1.0)


def capped_simplex_euclidean(z: torch.Tensor, h, iters: int = 64) -> torch.Tensor:
    """Euclidean projection onto B_h via bisection on the shift tau."""
    lo = torch.min(z) - 1.0
    hi = torch.max(z)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_big = torch.sum(torch.clamp(z - mid, 0.0, 1.0)) > h
        lo, hi = torch.where(too_big, mid, lo), torch.where(too_big, hi, mid)
    return torch.clamp(z - 0.5 * (lo + hi), 0.0, 1.0)
