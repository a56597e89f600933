"""Plain PyTorch versions of the port's kernels (port of `repro.kernels.ref`).

They keep every convention of the reference oracles: distances clamped at
0, masked rows at +inf, id -1 on underflow, -1 candidate slots reading as
+inf, and `k > P` padding.  Top-k selections use a stable sort, so equal
distances resolve to the lowest index as `lax.top_k` does (`torch.topk`
promises no order for ties).
"""

from __future__ import annotations

import torch


def smallest_k(d: torch.Tensor, k: int):
    """k smallest per row, ascending, lowest index first on ties (the
    lax.top_k rule; torch.topk promises no order for ties)."""
    vals, idx = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def pairwise_l2_ref(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, D), (N, D) -> (Q, N) squared euclidean distances, float32."""
    q = q.float()
    x = x.float()
    qn = torch.sum(q * q, dim=-1, keepdim=True)
    xn = torch.sum(x * x, dim=-1)[None, :]
    return torch.clamp_min(qn - 2.0 * (q @ x.T) + xn, 0.0)


def l2_topk_ref(q: torch.Tensor, x: torch.Tensor, k: int, valid=None):
    """Exact top-k smallest distances: (dists (Q, k), ids (Q, k) int32).

    `valid` (N,) bool marks live catalog rows: masked rows never surface,
    and queries with fewer than k live rows underflow as dist = +inf,
    id = -1.  With valid=None the output is the unmasked scan."""
    d = pairwise_l2_ref(q, x)
    if valid is not None:
        d = torch.where(valid[None, :], d, torch.full_like(d, float("inf")))
    vals, idx = smallest_k(d, k)
    idx = idx.to(torch.int32)
    if valid is not None:
        idx = torch.where(torch.isfinite(vals), idx, torch.full_like(idx, -1))
    return vals, idx


def ivf_scan_ref(q: torch.Tensor, x: torch.Tensor, cand: torch.Tensor, k: int,
                 valid=None):
    """Gathered-candidate top-k: q (B, D), x (N, D), cand (B, P) int with
    -1 marking invalid slots.  Returns (dists (B, k), ids (B, k) int32);
    ids = -1 (dist = +inf) when a query has fewer than k valid candidates,
    including the structural case k > P.  `valid` (N,) bool folds
    tombstoned candidate rows into -1 slots.  Distances are taken by
    difference, sum((x - q)^2), not by the GEMM expansion."""
    q = q.float()
    cand = cand.long()
    if valid is not None:
        cand = torch.where(
            (cand >= 0) & valid[torch.clamp(cand, 0, x.shape[0] - 1)], cand, -1)
    x = x.float()
    embs = x[torch.clamp_min(cand, 0)]                  # (B, P, D)
    diff = embs - q[:, None, :]
    d = torch.sum(diff * diff, dim=-1)
    d = torch.where(cand >= 0, d, torch.full_like(d, float("inf")))
    kk = min(k, cand.shape[1])
    vals, pos = smallest_k(d, kk)
    ids = torch.gather(cand, 1, pos)
    ids = torch.where(torch.isfinite(vals), ids, torch.full_like(ids, -1))
    if kk < k:
        b = cand.shape[0]
        ids = torch.cat([ids, ids.new_full((b, k - kk), -1)], dim=1)
        vals = torch.cat([vals, vals.new_full((b, k - kk), float("inf"))], dim=1)
    return vals, ids.to(torch.int32)
