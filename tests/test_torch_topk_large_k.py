"""The top-k kernels at k > 128 (up to ops.MAX_K = 1024), on the CPU.

The CUDA kernels run only on the card (chip_smoke.py holds `topk_l2`,
`ivf_scan_topk` and `ivf_scan_lists` against their plain versions there at
k 160, 400 and 1024).  Here:
  - a numpy emulation of topk_common.cuh's `warp_insert` (the stripe-wise
    shift of a sorted list in shared memory, 32 lanes a stripe) builds a
    list from candidates offered in ascending id order and must give the
    stable top k, ties at the k-th slot included; then the l2_topk plan
    (per-block lists over `topk_l2_plan`'s runs, merged by one stable sort
    in block order) must too;
  - the launch plans at k 160 / 400 / 1024: l2_topk's query tile shrinks
    so its lists fit a block's shared memory, and ivf_scan_lists' lists
    are sized by k;
  - the wrappers' plain paths at k > 128 against the JAX reference's
    `topk_l2_chunked` (the server oracle's scan) and `ivf_scan_topk`
    (which hands k > 128 to `ivf_scan_ref`), tombstones included.
Tolerances: distances rtol 1e-5, atol 1e-5 x the distance scale; ids equal
wherever the reference's margin to both neighbours exceeds that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops

LARGE_K = (160, 400, 1024)
RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def warp_insert(lv, li, k, v, vid):
    """topk_common.cuh's warp_insert on numpy lists: 32 lanes count the
    entries <= v, then the stripes from the top down each read their left
    neighbours (all lanes) before they write; lane 0 writes v at pos."""
    pos = int(np.sum(lv[:k] <= v))
    base = (k - 1) & ~31
    while base + 31 > pos:
        j = base + np.arange(32)
        move = (j < k) & (j > pos)
        tv, ti = lv[j[move] - 1].copy(), li[j[move] - 1].copy()  # read, then sync
        lv[j[move]], li[j[move]] = tv, ti
        base -= 32
    lv[pos], li[pos] = v, vid


def _list_of(d, k, ids=None):
    """A warp's list over distances d offered in order (ids default to
    positions): only values below the k-th are offered, as the kernels do."""
    lv = np.full(k, np.inf, np.float32)
    li = np.full(k, -1, np.int32)
    for i, v in enumerate(d):
        if v < lv[k - 1]:
            warp_insert(lv, li, k, v, i if ids is None else ids[i])
    return lv, li


def _stable_topk(d, k):
    order = np.argsort(d, kind="stable")[:k]
    vals = np.full(k, np.inf, np.float32)
    ids = np.full(k, -1, np.int32)
    vals[:len(order)] = d[order]
    ids[:len(order)] = np.where(np.isfinite(d[order]), order, -1)
    return vals, ids


@pytest.mark.parametrize("k", (64,) + LARGE_K)
@pytest.mark.parametrize("n", [700, 3000])
def test_warp_insert_emulation_keeps_the_stable_top_k(k, n):
    """Small-integer distances, so every slot ties (and the k-th with the
    (k+1)-th): the list is the stable top k, the lowest id first."""
    rng = np.random.default_rng(k + n)
    d = rng.integers(0, 40, n).astype(np.float32)
    d[rng.random(n) < 0.05] = np.inf
    lv, li = _list_of(d, k)
    wv, wi = _stable_topk(d, k)
    np.testing.assert_array_equal(lv, wv)
    np.testing.assert_array_equal(li, wi)


@pytest.mark.parametrize("k", LARGE_K)
def test_l2_topk_plan_emulation_merges_to_the_stable_top_k(k):
    """The l2_topk kernel at k > 128: each block's run (`topk_l2_plan`'s
    chunk, whole 128-row tiles) builds its own list by warp_insert; the
    wrapper sorts the (nblocks * k) partials stably in block order and
    keeps k.  Ties straddle every block's k-th slot."""
    rng = np.random.default_rng(k)
    n, nq = 6000, 2
    qt, chunk, nchunks = tops.topk_l2_plan(nq, n, 128, k, tops.l2_topk_smem_bytes_host)
    assert chunk % tops.TOPK_BN == 0 and nchunks == -(-n // chunk)
    for _ in range(nq):
        d = rng.integers(0, 300, n).astype(np.float32)
        pv, pi = [], []
        for y in range(nchunks):
            lv, li = _list_of(d[y * chunk:(y + 1) * chunk], k,
                              ids=np.arange(y * chunk, min(n, (y + 1) * chunk)))
            pv.append(lv)
            pi.append(li)
        pv, pi = np.concatenate(pv), np.concatenate(pi)
        order = np.argsort(pv, kind="stable")[:k]
        wv, wi = _stable_topk(d, k)
        np.testing.assert_array_equal(pv[order], wv)
        np.testing.assert_array_equal(pi[order], wi)


@pytest.mark.parametrize("nq,k,want", [
    (512, 160, 4),   # the server oracle's block at fig4's k' 160
    (64, 160, 4), (8, 160, 1),
    (512, 400, 2),   # fig4 --full's k' 400
    (512, 1024, 1), (64, 1024, 1)])
def test_l2_topk_query_tile_shrinks_for_long_lists(nq, k, want):
    """A block's BQ x k lists (8 bytes a pair) sit beside the ring: the
    plan keeps the widest query tile that fits, down to 16 queries at
    k 1024, at every width (the depth is streamed)."""
    smem = tops.l2_topk_smem_bytes_host
    for d in (128, 1024, 8192):
        qt = tops.topk_l2_query_tile(nq, d, k, smem)
        assert qt == want
        assert smem(qt, d, k) <= tops.SMEM_LIMIT
        if qt < 4 and nq > 16 * qt:
            assert smem(2 * qt, d, k) > tops.SMEM_LIMIT


@pytest.mark.parametrize("k", (10, 64, 128) + LARGE_K)
@pytest.mark.parametrize("d", [16, 33, 128, 256])
def test_ivf_scan_lists_smem_follows_k(k, d):
    """ivf_scan_lists sizes its eight lists by k (a power of two, at least
    32): every k up to the cap fits at every width it takes (D <= 256),
    and k <= 128 needs no more than the fixed 128-slot lists did."""
    for vec4 in ([0, 1] if d % 4 == 0 else [0]):
        size = tops.ivf_scan_lists_smem_bytes_host(d, vec4, k)
        assert size <= tops.SMEM_LIMIT
        fixed = size - 8 * 8 * max(32, 1 << (k - 1).bit_length()) + 8 * 8 * 128
        if k <= 128:
            assert size <= fixed
    kpow = tops.ivf_scan_lists_smem_bytes_host(128, 1, 1024) - \
        tops.ivf_scan_lists_smem_bytes_host(128, 1, 513)
    assert kpow == 0  # 513..1024 share the 1024-slot lists


def _check_topk(gd, gi, wd, wi, scale):
    gd, gi, wd, wi = (np.asarray(a) for a in (gd, gi, wd, wi))
    tol = 1e-5 * scale
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=tol)
    np.testing.assert_array_equal(gi == -1, wi == -1)
    finite = np.where(np.isfinite(wd), wd, 1e30)
    gap = np.diff(finite, axis=1)
    inf = np.full((wd.shape[0], 1), np.inf)
    margin = np.minimum(np.concatenate([inf, gap], 1), np.concatenate([gap, inf], 1))
    decided = margin > tol + RTOL * np.abs(finite)
    np.testing.assert_array_equal(gi[decided], wi[decided])


@pytest.mark.parametrize("k", LARGE_K)
@pytest.mark.parametrize("masked", [False, True])
def test_topk_l2_plain_path_at_large_k_matches_the_reference(k, masked):
    """topk_l2 and topk_l2_fused (the server oracle's scan) at k > 128
    against the reference's chunked oracle, with tombstones; k 1024 is
    beyond the 700 live rows, so the tail underflows as +inf / -1."""
    rng = np.random.default_rng(k)
    x = rng.random((900, 16), np.float32)
    q = rng.random((5, 16), np.float32)
    valid = rng.random(900) > 0.2 if masked else None
    jv = None if valid is None else jnp.array(valid)
    tv = None if valid is None else _t(valid)
    wd, wi = jops.topk_l2_chunked(jnp.array(q), jnp.array(x), k, 256, jv)
    if valid is None:
        wi = np.where(np.isfinite(np.asarray(wd)), np.asarray(wi), -1)
    for gd, gi in (tops.topk_l2(_t(q), _t(x), k, valid=tv),
                   tops.topk_l2_fused(_t(q), _t(x), k, chunk=256, valid=tv)):
        _check_topk(gd, gi, wd, wi, scale=16.0)
        if valid is not None:
            assert not np.isin(gi.numpy(), np.flatnonzero(~valid)).any()


@pytest.mark.parametrize("k", LARGE_K)
def test_ivf_scans_plain_path_at_large_k_match_the_reference(k):
    """ivf_scan_topk at k > 128 against the reference's (its XLA branch for
    k > BP), tombstones folded; ivf_scan_lists over padded lists against
    the reference's scan of the probed table."""
    rng = np.random.default_rng(7 + k)
    n, d, b, p = 3000, 24, 4, 1500
    x = rng.random((n, d), np.float32)
    q = rng.random((b, d), np.float32)
    cand = rng.integers(-1, n, (b, p)).astype(np.int32)
    valid = rng.random(n) > 0.1
    gd, gi = tops.ivf_scan_topk(_t(q), _t(x), _t(cand), k, valid=_t(valid))
    wd, wi = jops.ivf_scan_topk(jnp.array(q), jnp.array(x), jnp.array(cand), k,
                                valid=jnp.array(valid), interpret=True)
    _check_topk(gd, gi, wd, wi, scale=float(d))
    assert not np.isin(gi.numpy(), np.flatnonzero(~valid)).any()

    nlist, cap, nprobe = 30, 150, 6
    inv = np.full((nlist, cap), -1, np.int32)
    owner = rng.integers(0, nlist, n)
    for l in range(nlist):
        rows = np.flatnonzero(owner == l)[:cap]
        inv[l, :len(rows)] = rows
    probe = np.stack([rng.choice(nlist, nprobe, replace=False) for _ in range(b)])
    probe = probe.astype(np.int32)
    gd, gi = tops.ivf_scan_lists(_t(q), _t(x), _t(inv), _t(probe), k)
    table = inv[probe].reshape(b, nprobe * cap)
    wd, wi = jref.ivf_scan_ref(jnp.array(q), jnp.array(x), jnp.array(table), k)
    _check_topk(gd, gi, wd, wi, scale=float(d))
