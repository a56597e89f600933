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


def _adc_sum(lut: torch.Tensor, code_at) -> torch.Tensor:
    """Σ_m lut[b, m, code_at(m)] for a (B, ...) index of codes per subspace,
    summed in m order with one float32 add at a time: the reference
    kernel's order (its fori_loop over m adds one one-hot product, which
    has exactly one non-zero term, to the running sum), so the result is
    bitwise ((0 + l_0) + l_1) + ...  Codes >= C add 0, as the one-hot does."""
    lut = lut.float()
    c = lut.shape[2]
    acc = None
    for mi in range(lut.shape[1]):
        code = code_at(mi)
        term = torch.gather(lut[:, mi, :], 1, torch.clamp(code, 0, c - 1))
        term = torch.where(code < c, term, torch.zeros_like(term))
        acc = term if acc is None else acc + term
    return acc


def pq_adc_ref(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """PQ asymmetric distances: lut (Q, M, C) float32 per-query,
    per-subspace tables, codes (N, M) integer in [0, C) ->
    (Q, N) float32, dist[q, n] = Σ_m lut[q, m, codes[n, m]]."""
    q = lut.shape[0]
    codes = codes.long()
    return _adc_sum(lut, lambda mi: codes[:, mi][None, :].expand(q, -1))


def pq_adc_gather_ref(lut: torch.Tensor, codes: torch.Tensor,
                      cand: torch.Tensor) -> torch.Tensor:
    """The ADC scan at per-query candidate rows: lut (B, M, C), codes
    (N, M), cand (B, P) int with -1 marking an invalid slot ->
    (B, P) float32, out[b, p] = Σ_m lut[b, m, codes[cand[b, p], m]] and
    +inf on -1 slots.  Equal, slot for slot, to `pq_adc_ref(lut, codes)`
    read at the candidate rows."""
    cand = cand.long()
    safe = torch.clamp_min(cand, 0)
    codes = codes.long()
    d = _adc_sum(lut, lambda mi: codes[:, mi][safe])
    return torch.where(cand >= 0, d, torch.full_like(d, float("inf")))
