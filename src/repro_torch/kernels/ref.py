"""Plain PyTorch versions of the port's kernels (port of `repro.kernels.ref`,
and of `_sdpa_flash` in `repro.models.layers` for `flash_attention`).

They keep every convention of the reference oracles: distances clamped at
0, masked rows at +inf, id -1 on underflow, -1 candidate slots reading as
+inf, and `k > P` padding.  Top-k selections use a stable sort, so equal
distances resolve to the lowest index as `lax.top_k` does (`torch.topk`
promises no order for ties).
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint


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


def pairwise_l2_batched_ref(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """q (M, Q, d), x (M, C, d) -> (Q, M, C): the stack of pairwise_l2_ref
    over the M pairs, bitwise (each pair on its own)."""
    return torch.stack([pairwise_l2_ref(q[i].contiguous(), x[i].contiguous())
                        for i in range(q.shape[0])], dim=1)


def _underflow(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """A top-k's tail conventions: id -1 wherever the distance is +inf, and
    fewer than k columns (k beyond the scanned width) padded to k with
    +inf / -1.  ids come back int32."""
    ids = torch.where(torch.isfinite(vals), ids, torch.full_like(ids, -1))
    short = k - vals.shape[1]
    if short > 0:
        ids = torch.cat([ids, ids.new_full((ids.shape[0], short), -1)], dim=1)
        vals = torch.cat([vals, vals.new_full((vals.shape[0], short), float("inf"))],
                         dim=1)
    return vals, ids.to(torch.int32)


def l2_topk_ref(q: torch.Tensor, x: torch.Tensor, k: int, valid=None):
    """Exact top-k smallest distances: (dists (Q, k), ids (Q, k) int32).

    `valid` (N,) bool marks live catalog rows: masked rows never surface.
    Slots past the live rows underflow as dist = +inf, id = -1, including
    k > N (the CUDA kernel's shape).  With valid=None the output is the
    unmasked scan."""
    d = pairwise_l2_ref(q, x)
    if valid is not None:
        d = torch.where(valid[None, :], d, torch.full_like(d, float("inf")))
    return _underflow(*smallest_k(d, k), k)


def l2_topk_chunked_ref(q: torch.Tensor, x: torch.Tensor, k: int, chunk: int,
                        valid=None):
    """`l2_topk_ref` without the (Q, N) matrix: `chunk` catalog rows at a
    time, each chunk's distances merged into a running (Q, k) best by a
    stable sort of [best, chunk] (port of the reference's
    `topk_l2_chunked`).  The best holds only lower ids than the chunk, so
    ties go to the lowest id as in one sort of the whole row: the result
    is bitwise `l2_topk_ref`'s, tail conventions included."""
    nq, n = q.shape[0], x.shape[0]
    if chunk < 1:
        raise ValueError(f"l2_topk_chunked_ref: chunk must be >= 1, got {chunk}")
    best_d = torch.full((nq, k), float("inf"), dtype=torch.float32, device=q.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=q.device)
    for s in range(0, n, chunk):
        d = pairwise_l2_ref(q, x[s:s + chunk])
        if valid is not None:
            d = torch.where(valid[None, s:s + chunk], d, torch.full_like(d, float("inf")))
        ids = torch.arange(s, s + d.shape[1], device=q.device).expand(nq, -1)
        vals, pos = smallest_k(torch.cat([best_d, d], dim=1), k)
        best_i = torch.gather(torch.cat([best_i, ids], dim=1), 1, pos)
        best_d = vals
    return _underflow(best_d, best_i, k)


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
    vals, pos = smallest_k(d, k)
    return _underflow(vals, torch.gather(cand, 1, pos), k)


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


def probed_table(invlists: torch.Tensor, probe: torch.Tensor) -> torch.Tensor:
    """(B, nprobe * cap) int32: the ids of the lists `probe` (B, nprobe)
    names, in probe order, -1 = pad.  An entry outside [0, nlist) names no
    list: its cap slots are -1."""
    nlist = invlists.shape[0]
    p = probe.long()
    rows = invlists[p.clamp(0, max(nlist - 1, 0))]
    inside = ((p >= 0) & (p < nlist))[..., None]
    return torch.where(inside, rows, torch.full_like(rows, -1)).reshape(probe.shape[0], -1)


def pq_shortlist_ref(lut: torch.Tensor, codes_lists: torch.Tensor,
                     invlists: torch.Tensor, probe: torch.Tensor, kk: int, valid=None):
    """The IVF-PQ shortlist: (ADC distances (B, kk), ids (B, kk) int32), the
    stable top kk of `pq_adc_gather_ref(lut, codes, table)` over the probed
    lists' table `probed_table(invlists, probe)` (ties to the lowest
    position r * cap + slot, as lax.top_k), ids -1 and distances +inf where
    the probed slots run out (kk beyond them included).

    lut (B, M, C); codes_lists (nlist, ccap >= cap, M) holds each listed
    slot's code row, codes_lists[l, s] = codes[invlists[l, s]]; `valid`
    (N,) bool folds tombstoned ids to -1 slots, as the reference's masked
    branch does."""
    b, nprobe = probe.shape
    nlist, cap = invlists.shape
    table = probed_table(invlists, probe)
    if valid is not None:
        safe = torch.clamp(table, 0, valid.shape[0] - 1).long()
        table = torch.where((table >= 0) & valid[safe], table, torch.full_like(table, -1))
    rows = codes_lists[probe.long().clamp(0, max(nlist - 1, 0))][:, :, :cap]
    rows = rows.reshape(b, nprobe * cap, -1).long()                # (B, P, M)
    d = _adc_sum(lut, lambda mi: rows[:, :, mi])
    d = torch.where(table >= 0, d, torch.full_like(d, float("inf")))
    vals, pos = smallest_k(d, kk)
    return _underflow(vals, torch.gather(table, 1, pos), kk)


def _flash_chunk(qg, k_blk, v_blk, m, l, acc, q_pos, k0: int, causal: bool, window: int,
                 written_upto, scale: float):
    """One KV chunk of the online softmax: the running (max, denominator,
    accumulator) after keys k0 .. k0 + len(k_blk) (the reference's scan
    body)."""
    s = qg.shape[1]
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k_blk.float()) * scale
    k_pos = k0 + torch.arange(k_blk.shape[1], device=qg.device)
    ok = torch.ones((s, k_blk.shape[1]), dtype=torch.bool, device=qg.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    if written_upto is not None:
        ok &= k_pos[None, :] < written_upto
    logits = logits.masked_fill(~ok, float("-inf"))
    m_new = torch.maximum(m, logits.amax(dim=-1))
    # rows with no kept key yet keep m = -inf; guard the exp shift
    shift = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    p = torch.exp(logits - shift[..., None]).masked_fill(~ok, 0.0)
    rescale = torch.where(torch.isfinite(m), torch.exp(m - shift), torch.zeros_like(m))
    l = l * rescale + p.sum(dim=-1)
    acc = acc * rescale[..., None] + torch.einsum("bkgst,btkd->bkgsd", p, v_blk.float())
    return m_new, l, acc


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0, q_offset: int = 0,
                        written_upto: int | None = None,
                        chunk: int = 2048, checkpoint_chunks: bool = False) -> torch.Tensor:
    """Chunked online-softmax attention (port of the reference's
    `_sdpa_flash`, f32 throughout): q (B, S, H, D), k / v (B, T, KV, D) ->
    (B, S, H, Dv) in q's dtype.

    Query row i sits at absolute position q_offset + i and keeps key j when
    j <= it (causal), j > it - window (window > 0) and j < written_upto
    (None = T).  GQA maps q head h onto kv head h // (H // KV).  Masked
    logits are -inf and add p = 0; the running max is guarded by isfinite,
    so a row with no kept key returns 0 (acc / max(l, 1e-30)).  T need not
    be a multiple of `chunk`: the last chunk is short.

    checkpoint_chunks: run each chunk under `torch.utils.checkpoint`, as
    the reference wraps its scan body in `jax.checkpoint`: a backward
    keeps only the running (max, denominator, accumulator) of each chunk
    and recomputes its logits, O(S * chunk) live logits instead of
    O(S * T)."""
    b, s, h, dd = q.shape
    t, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, dd).float()
    q_pos = q_offset + torch.arange(s, device=q.device)
    scale = 1.0 / (dd ** 0.5)
    m = torch.full((b, kvh, g, s), float("-inf"), device=q.device)
    l = torch.zeros((b, kvh, g, s), device=q.device)
    acc = torch.zeros((b, kvh, g, s, dv), device=q.device)
    for j in range(0, t, chunk):
        args = (qg, k[:, j:j + chunk], v[:, j:j + chunk], m, l, acc, q_pos, j, causal,
                window, written_upto, scale)
        if checkpoint_chunks:
            m, l, acc = torch.utils.checkpoint.checkpoint(_flash_chunk, *args,
                                                          use_reentrant=False)
        else:
            m, l, acc = _flash_chunk(*args)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4)  # (b, kvh, g, s, d) -> (b, s, kvh, g, d)
    return out.reshape(b, s, h, dv).to(q.dtype)
