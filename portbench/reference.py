"""The plain reference of one AÇAI serving step (arXiv:2107.00957, Sec. IV),
and the data the benchmark prepares for both sides.

Plain PyTorch and NumPy; it imports nothing of the program.  It works out
from the same inputs what the program's timed step produces:

- the candidates: the k nearest rows of the remote index (every row for the
  flat index; the rows of the `nprobe` lists whose centroids lie nearest for
  IVF) and the `c_local` nearest of the cached rows (the first `2h + 64` of
  them by id), the duplicates of a request's candidates dropped;
- Eq. (2) serving: each candidate offers one copy, the local one (cost d)
  where it is cached and else the remote one (d + c_f); a request is served
  by its k cheapest copies; its gain is what that saves against fetching
  its k nearest candidates;
- the subgradient of the gain of Eq. (7) in App. C's form (Eq. (55)), the
  batch's mean, the negentropy OMA step (y * exp(eta B g)) and the Bregman
  projection onto {y in [0, 1]^N : sum y = h};
- coupled rounding (Algorithm 2) and DepRound, given their uniforms.

Distances are exact: candidates are screened in float32 and ranked again in
float64, so ties fall only where float64 cannot part two rows.  The
control (`precision="tf32"`) puts the distance products in TF32, the
precision below the configuration's float32 with TF32 off.

A request is a near tie where one of its choices is closer than a float32
distance can part: the `nprobe`-th and next list, the `c_remote`-th and next
row, the `c_local`-th and next cached row, or the k-th and next copy of
Eq. (2).  Two rows' float32 distances may come out in either order there,
so the request's answer is not held against the program.
"""

from __future__ import annotations

import numpy as np
import torch

BIG_COST = 1e9   # an invalid candidate slot's distance
Y_FLOOR = 1e-12  # the projection keeps y in the open domain of the entropy
_MARGIN = 32     # extra float32 candidates ranked again in float64
_EXP_CLIP = 60.0
# a near tie: two distances closer than this share of |q|^2 + max |x|^2, the
# magnitudes a float32 norm expansion cancels (its rounding over 128 terms
# reads ~1e-7 of them, Higham and Mary's probabilistic bound sqrt(d) 2^-24)
TIE_REL = 4e-6


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32(a: torch.Tensor) -> torch.Tensor:
    """a rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero), as a tensor core rounds a float32 operand."""
    return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _dist32(q: torch.Tensor, x: torch.Tensor, precision: str) -> torch.Tensor:
    """(B, d), (P, d) -> (B, P) float32 squared distances by the norm
    expansion; the products in TF32 for the control."""
    _no_tf32()
    qn = (q * q).sum(1, keepdim=True)
    xn = (x * x).sum(1)[None, :]
    if precision == "tf32":
        prod = tf32(q) @ tf32(x).T
    else:
        prod = q @ x.T
    return torch.clamp_min(qn + xn - 2.0 * prod, 0.0)


def _dist32_rows(q: torch.Tensor, xg: torch.Tensor, precision: str) -> torch.Tensor:
    """(B, d), (B, P, d) -> (B, P): each query against its own rows."""
    _no_tf32()
    if precision == "tf32":
        qn = (q * q).sum(1, keepdim=True)
        xn = (xg * xg).sum(2)
        prod = torch.bmm(tf32(xg), tf32(q)[:, :, None])[:, :, 0]
        return torch.clamp_min(qn + xn - 2.0 * prod, 0.0)
    return ((xg - q[:, None, :]) ** 2).sum(2)


def _rank(q: torch.Tensor, rows: torch.Tensor, cand: torch.Tensor, d32: torch.Tensor,
          k: int, precision: str):
    """The k best of `cand` (B, P') ids into `rows` (an id past the rows is
    an empty slot), ascending, lower id first on ties: by float64
    distances, or by the TF32 ones for the control.  Returns (float64
    distances, ids), each (B, k); an empty slot reads +inf / -1."""
    n = rows.shape[0]
    empty = cand >= n
    if precision == "tf32":
        d = d32.double()
    else:
        diff = rows[torch.clamp_max(cand, n - 1)].double() - q.double()[:, None, :]
        d = (diff * diff).sum(2)
    d = torch.where(empty, torch.full_like(d, float("inf")), d)
    by_id = torch.argsort(cand, dim=1, stable=True)
    cand, d = torch.gather(cand, 1, by_id), torch.gather(d, 1, by_id)
    order = torch.argsort(d, dim=1, stable=True)[:, :k]
    d, ids = torch.gather(d, 1, order), torch.gather(cand, 1, order)
    return d, torch.where(ids >= n, torch.full_like(ids, -1), ids)


def _gap(d: torch.Tensor, k: int) -> torch.Tensor:
    """(B,) the distance from the k-th to the (k+1)-th of each row of an
    ascending (B, P) `d`; +inf where neither or only the k-th exists."""
    if d.shape[1] <= k:
        return torch.full(d.shape[:1], float("inf"), dtype=torch.float64, device=d.device)
    return torch.nan_to_num(d[:, k] - d[:, k - 1], nan=float("inf"), posinf=float("inf"))


def nearest(q: torch.Tensor, rows: torch.Tensor, k: int, precision: str = "exact",
            block: int = 32):
    """The k nearest of all `rows` (P, d) for each query (B, d): (float64
    distances, ids), each (B, k), +inf / -1 past P, and the (B,) gap from
    the k-th to the (k+1)-th nearest."""
    out_d, out_i = [], []
    take = min(k + 1 + _MARGIN, rows.shape[0])
    for s in range(0, q.shape[0], block):
        qb = q[s:s + block]
        d32 = _dist32(qb, rows, precision)
        top = torch.topk(d32, take, dim=1, largest=False)
        d, i = _rank(qb, rows, top.indices, top.values, min(k + 1, take), precision)
        out_d.append(d)
        out_i.append(i)
    d, i = torch.cat(out_d), torch.cat(out_i)
    if i.shape[1] < k + 1:
        pad = k + 1 - i.shape[1]
        d = torch.cat([d, d.new_full((d.shape[0], pad), float("inf"))], 1)
        i = torch.cat([i, i.new_full((i.shape[0], pad), -1)], 1)
    return d[:, :k], i[:, :k], _gap(d, k)


def ivf_nearest(q: torch.Tensor, rows: torch.Tensor, centroids: torch.Tensor,
                invlists: torch.Tensor, nprobe: int, k: int, precision: str = "exact",
                block: int = 8):
    """IVF's answer: the k nearest rows among the `nprobe` lists whose
    centroids lie nearest each query (nearer list first, the lower list on
    ties).  invlists (nlist, cap) int64, -1 after a list's ids.  Returns
    (distances, ids, gap): the gap is the smaller of the `nprobe`-th to the
    next list's and the k-th to the next row's."""
    if precision == "tf32":
        dc = _dist32(q, centroids, precision).double()
    else:
        diff = q.double()[:, None, :] - centroids.double()[None, :, :]
        dc = (diff * diff).sum(2)
    by_list = torch.argsort(dc, dim=1, stable=True)
    probe = by_list[:, :nprobe]
    list_gap = _gap(torch.gather(dc, 1, by_list), nprobe)
    out_d, out_i, out_g = [], [], []
    for s in range(0, q.shape[0], block):
        qb = q[s:s + block]
        cand = invlists[probe[s:s + block]].reshape(qb.shape[0], -1)   # (b, P)
        xg = rows[torch.clamp_min(cand, 0)]
        d32 = _dist32_rows(qb, xg, precision)
        d32 = torch.where(cand >= 0, d32, torch.full_like(d32, float("inf")))
        del xg
        top = torch.topk(d32, min(k + 1 + _MARGIN, d32.shape[1]), dim=1, largest=False)
        ids = torch.gather(cand, 1, top.indices)
        ids = torch.where(ids >= 0, ids, torch.full_like(ids, rows.shape[0]))
        d, i = _rank(qb, rows, ids, top.values, k + 1, precision)
        out_d.append(d[:, :k])
        out_i.append(i[:, :k])
        out_g.append(_gap(d, k))
    return torch.cat(out_d), torch.cat(out_i), torch.minimum(list_gap, torch.cat(out_g))


def candidates(q, rows, x, cfg: dict, index, precision: str = "exact"):
    """The step's candidate slab: (ids (B, C) with n on an invalid slot,
    float64 distances with BIG_COST there, valid (B, C), the (B,) smallest
    gap at a choice's boundary), C = c_remote + c_local.  `index` is None
    for the flat scan, else a dict with the IVF's centroids, invlists and
    nprobe."""
    n = rows.shape[0]
    c_remote, c_local, h = cfg["c_remote"], cfg["c_local"], cfg["h"]
    if index is None:
        d_r, i_r, gap = nearest(q, rows, c_remote, precision)
    else:
        d_r, i_r, gap = ivf_nearest(q, rows, index["centroids"], index["invlists"],
                               index["nprobe"], c_remote, precision)
    cached = torch.nonzero(x > 0.5).flatten()[:min(n, 2 * h + 64)]
    if cached.numel():
        d_l, pos, gap_l = nearest(q, rows[cached], c_local, precision)
        i_l = torch.where(pos >= 0, cached[torch.clamp_min(pos, 0)], pos)
        gap = torch.minimum(gap, gap_l)
    else:
        d_l = torch.full((q.shape[0], c_local), float("inf"), dtype=torch.float64,
                         device=q.device)
        i_l = torch.full((q.shape[0], c_local), -1, dtype=torch.long, device=q.device)
    ids = torch.cat([i_r, i_l], 1)
    d = torch.cat([d_r, d_l], 1)
    ids = torch.where(ids >= 0, ids, torch.full_like(ids, n))
    # a row named twice in one request counts once, at its first slot
    valid = ids < n
    same = (ids[:, :, None] == ids[:, None, :]) & valid[:, None, :]
    earlier = torch.tril(torch.ones(ids.shape[1], ids.shape[1], dtype=torch.bool,
                                    device=ids.device), -1)
    valid = valid & ~(same & earlier[None]).any(2)
    d = torch.where(valid, d, torch.full_like(d, BIG_COST))
    return ids, d, valid, gap


def serve(d: torch.Tensor, x_cand: torch.Tensor, k: int, c_f: float):
    """Eq. (2): every candidate offers one copy, local (cost d) if cached,
    else remote (d + c_f); the k cheapest serve.  Returns (cost, gain,
    served_local, the gap from the k-th cheapest copy to the next), each
    (B,)."""
    local = x_cand > 0.5
    eff = d + c_f * (~local).double()
    by_cost = torch.argsort(eff, dim=1, stable=True)
    order = by_cost[:, :k]
    cost = torch.gather(eff, 1, order).sum(1)
    served_local = torch.gather(local, 1, order).sum(1)
    empty = torch.sort(d, dim=1).values[:, :k].sum(1) + k * c_f
    gap = _gap(torch.gather(eff, 1, by_cost), k)
    return cost, torch.clamp_min(empty - cost, 0.0), served_local, gap


def subgradient(d: torch.Tensor, y_cand: torch.Tensor, k: int, c_f: float) -> torch.Tensor:
    """A subgradient of the gain G(r, y) of Eq. (7) in y, App. C (Eq. (55)).

    Each candidate l has a local entry (cost d_l, weight y_l) and a remote
    one (d_l + c_f, weight 1 - y_l); in ascending cost order (locals first
    on ties) S_i sums the weights up to entry i and T is the last i with
    S_i < k.  With b_l = min(rpos_l - 1, T), g_l = c_{b_l + 1} - d_l where
    the local entry lies at or before b_l, else 0."""
    b, c = d.shape
    cost = torch.cat([d, d + c_f], 1)
    w = torch.cat([y_cand, 1.0 - y_cand], 1)
    order = torch.argsort(cost, dim=1, stable=True)
    pos = torch.empty_like(order)
    pos.scatter_(1, order, torch.arange(2 * c, device=d.device).expand(b, -1).contiguous())
    cs = torch.gather(cost, 1, order)
    s = torch.cumsum(torch.gather(w, 1, order), 1)
    t = (s < k).sum(1, keepdim=True) - 1
    lpos, rpos = pos[:, :c], pos[:, c:]
    bl = torch.minimum(rpos - 1, t)
    upper = torch.gather(cs, 1, torch.clamp(bl + 1, 0, 2 * c - 1))
    g = torch.where(lpos <= bl, upper - d, torch.zeros_like(d))
    return torch.clamp_min(g, 0.0)


def project(z: torch.Tensor, h: float) -> torch.Tensor:
    """The negentropy Bregman projection onto the capped simplex: y =
    min(1, s z) with the s that makes sum y = h (float64)."""
    n = z.shape[0]
    z = torch.clamp_min(z.double(), 0.0)
    if h >= n:
        return torch.ones_like(z)
    zs = torch.sort(z, descending=True).values
    tail = torch.flip(torch.cumsum(torch.flip(zs, (0,)), 0), (0,))   # sum of zs[m:]
    m = torch.arange(n, dtype=torch.float64, device=z.device)
    s_m = (h - m) / torch.clamp_min(tail, 1e-300)
    prev = torch.cat([zs.new_full((1,), float("inf")), zs[:-1]])
    ok = (zs * s_m <= 1.0 + 1e-12) & (prev * s_m >= 1.0 - 1e-12) & (h - m > 0)
    first = torch.nonzero(ok).flatten()
    if first.numel():
        s = s_m[first[0]]
    else:  # no split met the conditions in float64: bisect on s
        lo, hi = 0.0, 1.0 / float(zs[zs > 0][-1])
        for _ in range(200):
            s = 0.5 * (lo + hi)
            lo, hi = (s, hi) if float(torch.clamp_max(z * s, 1.0).sum()) < h else (lo, s)
        s = 0.5 * (lo + hi)
    return torch.clamp(z * s, Y_FLOOR, 1.0)


def coupled_rounding(u: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     y_new: torch.Tensor) -> torch.Tensor:
    """Algorithm 2 in float32: a cached object is evicted with probability
    (y - y') / y where y falls, an absent one fetched with (y' - y) / (1 - y)
    where y rises, each by its own uniform."""
    delta = y_new - y
    p_evict = -delta / torch.clamp_min(y, 1e-9)
    p_fetch = delta / torch.clamp_min(1.0 - y, 1e-9)
    evict = (x > 0.5) & (delta < 0) & (u < p_evict)
    fetch = (x < 0.5) & (delta > 0) & (u < p_fetch)
    out = torch.where(fetch, torch.ones_like(x), x)
    return torch.where(evict, torch.zeros_like(x), out)


def depround(u: np.ndarray, y: np.ndarray) -> np.ndarray:
    """DepRound (Byrka et al.) on the host in float32: one pair a step, the
    running fractional coordinate against the next, the pair's mass moved
    to make one of them integral (by u_i), the integral one frozen.  `u`
    holds N - 1 uniforms.  Returns x in {0, 1}^N as float32."""
    f32 = np.float32
    n = y.shape[0]
    one, eps = f32(1.0), f32(1e-9)
    lo, hi = f32(1e-8), f32(1.0 - 1e-8)
    yv = list(np.asarray(y, np.float32)[1:])
    uv = list(np.asarray(u, np.float32)[:n - 1])
    out = np.zeros(n, np.float32)
    cur, p = 0, f32(y[0])
    for i in range(1, n):
        q, ui = yv[i - 1], uv[i - 1]
        up = min(one - p, q)     # mass p can take from q
        down = min(p, one - q)   # mass q can take from p
        tot = up + down
        if tot <= eps:
            p_new, q_new = p, q
        elif ui * tot < down:
            p_new, q_new = p + up, q - up
        else:
            p_new, q_new = p - down, q + down
        if p_new <= lo or p_new >= hi:
            out[cur] = p_new
            cur, p = i, q_new
        else:
            out[i] = q_new
            p = p_new
    out[cur] = p
    return np.round(out).astype(np.float32)


def step(q, rows, y, x, cfg: dict, index, batch: int, precision: str = "exact"):
    """One mini-batch step from the state (y, x): the candidates, Eq. (2)'s
    serving, the batch's mean subgradient, the OMA step and the projection.
    Returns a dict of (B,) cost, gain, served_local, rel_gap (the smallest
    gap at one of the request's choices over |q|^2 + max |x|^2: a near tie
    below TIE_REL); (N,) float64 g (the scattered mean subgradient) and
    y_new."""
    k, c_f, h = cfg["k"], cfg["c_f"], cfg["h"]
    n = rows.shape[0]
    ids, d, valid, gap = candidates(q, rows, x, cfg, index, precision)
    safe = torch.clamp_max(ids, n - 1)
    zero = torch.zeros((), dtype=torch.float64, device=q.device)
    x_c = torch.where(valid, x[safe].double(), zero)
    y_c = torch.where(valid, y[safe].double(), zero)
    cost, gain, served_local, gap_serve = serve(d, x_c, k, c_f)
    scale = (q.double() ** 2).sum(1) + float((rows * rows).sum(1).max())
    rel_gap = torch.minimum(gap, gap_serve) / scale
    g = subgradient(d, y_c, k, c_f) / batch
    g_full = torch.zeros(n + 1, dtype=torch.float64, device=q.device)
    g_full.index_add_(0, torch.where(valid, ids, torch.full_like(ids, n)).reshape(-1),
                      torch.where(valid, g, zero).reshape(-1))
    g_full = g_full[:n]
    eta = cfg["eta"] * batch
    z = y.double() * torch.exp(torch.clamp(eta * g_full, -_EXP_CLIP, _EXP_CLIP))
    return {"cost": cost, "gain": gain, "served_local": served_local, "rel_gap": rel_gap,
            "g": g_full,
            "y_new": project(z, h)}


def kmeans_lists(rows: torch.Tensor, nlist: int, iters: int, init_idx: torch.Tensor,
                 block: int = 131072):
    """Lloyd's k-means from the rows `init_idx`, `iters` rounds, then the
    inverted lists: (centroids (nlist, d) float32, invlists (nlist, cap)
    int32 numpy with each list's ids ascending and -1 after them).  A
    cluster's sum is a product with its one-hot rows, block by block in a
    fixed order (no atomics), so a seed gives the same lists on every run."""
    n = rows.shape[0]

    def assign(cents):
        out = torch.empty(n, dtype=torch.long, device=rows.device)
        for s in range(0, n, block):
            out[s:s + block] = torch.argmin(_dist32(rows[s:s + block], cents, "exact"), 1)
        return out

    cents = rows[init_idx].clone()
    for _ in range(iters):
        a = assign(cents)
        sums = torch.zeros((nlist, rows.shape[1]), dtype=torch.float32, device=rows.device)
        for s in range(0, n, block):
            a_b = a[s:s + block]
            onehot = torch.zeros((nlist, a_b.shape[0]), dtype=torch.float32,
                                 device=rows.device)
            onehot[a_b, torch.arange(a_b.shape[0], device=rows.device)] = 1.0
            sums += onehot @ rows[s:s + block]
        counts = torch.bincount(a, minlength=nlist)
        new = sums / torch.clamp_min(counts, 1)[:, None].float()
        cents = torch.where(counts[:, None] > 0, new, cents)
    a = assign(cents).cpu().numpy()
    counts = np.bincount(a, minlength=nlist)
    table = np.full((nlist, int(counts.max())), -1, np.int32)
    order = np.argsort(a, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    col = np.arange(n) - starts[a[order]]
    table[a[order], col] = order
    return cents.contiguous(), table
