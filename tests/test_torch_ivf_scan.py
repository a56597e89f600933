"""The per-query `ivf_scan` kernel's launch plan and selection, on the CPU.

The CUDA kernel (csrc/ivf_scan.cu) runs only on the card, where
chip_smoke.py holds it against its plain version and counts one device
kernel a call.  Here:
  - `ops.ivf_scan_plan` as host arithmetic: the runs tile P, the cluster
    holds at most 16 blocks, the shared memory fits, and every k up to
    MAX_K fits a pass's keys beside the kept ones;
  - a numpy emulation of the kernel's selection: each block's runs walked
    in passes of IVF_PASS slots, a scored slot one 64-bit key (distance
    bits << 32 | position) kept when it beats the block's k-th best, the
    kept and new keys sorted by the kernel's bitonic network, then the
    cluster's lists merged by rank (a key's index plus its count of
    smaller keys in every other list) and positions mapped to ids.  It is
    fed the plain version's own float32 distances, so every distance and
    every id, ties included, must equal `ref.ivf_scan_ref`'s; against the
    JAX reference (its Pallas kernel in interpret mode where it takes k,
    else its `ivf_scan_ref`) distances agree to rtol 1e-5 and atol 1e-5 x
    the distance scale, and ids wherever the reference's margin to both
    neighbours exceeds that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RTOL = 1e-5
EMPTY = np.uint64(2 ** 64 - 1)
INF_BITS = 0x7F800000


def _t(a):
    return torch.from_numpy(np.array(a))


def _pow2(n):
    return 1 << max(n - 1, 0).bit_length()


def bitonic_sort(keys):
    """ivf_scan.cu's `bitonic_sort` on a power-of-two numpy array: at each
    (size, stride) pair i compares lo = 2 i - (i & (stride - 1)) with lo +
    stride, ascending where lo & size is 0."""
    keys = keys.copy()
    n = keys.size
    i = np.arange(n // 2)
    size = 2
    while size <= n:
        stride = size // 2
        while stride:
            lo = 2 * i - (i & (stride - 1))
            hi = lo + stride
            a, b = keys[lo], keys[hi]
            swap = (a > b) == ((lo & size) == 0)
            keys[lo[swap]], keys[hi[swap]] = b[swap], a[swap]
            stride //= 2
        size *= 2
    return keys


def emulate(dist, cand, k, n, valid=None, plan=None):
    """The kernel's outputs from (B, P) float32 distances: (dists (B, k),
    ids (B, k) int32)."""
    b, p = cand.shape
    blocks, run, cluster = tops.ivf_scan_plan(b, p, k) if plan is None else plan
    assert blocks == cluster and cluster * run >= p
    kp = _pow2(k)
    live = (cand >= 0) & (cand < n)
    if valid is not None:
        live &= valid[np.clip(cand, 0, n - 1)]
    bits = dist.astype(np.float32).view(np.uint32)
    out_d = np.empty((b, k), np.float32)
    out_i = np.empty((b, k), np.int32)
    for qi in range(b):
        lists = []
        for r in range(cluster):
            kept = np.full(kp, EMPTY, np.uint64)
            begin = min(p, r * run)
            end = min(p, begin + run)
            for s0 in range(begin, end, tops.IVF_PASS):
                s1 = min(end, s0 + tops.IVF_PASS)
                thr = kept[k - 1]
                pos = np.arange(s0, s1, dtype=np.uint64)
                key = (bits[qi, s0:s1].astype(np.uint64) << np.uint64(32)) | pos
                new = key[live[qi, s0:s1] & (bits[qi, s0:s1] < INF_BITS) & (key < thr)]
                assert new.size <= tops.IVF_PASS
                if new.size:
                    m = _pow2(kp + new.size)
                    buf = np.full(m, EMPTY, np.uint64)
                    buf[:kp], buf[kp:kp + new.size] = kept, new
                    kept = bitonic_sort(buf)[:kp]
            own = kept[:k]
            lists.append(own[own != EMPTY])
        out_d[qi], out_i[qi] = np.inf, -1
        for r, own in enumerate(lists):
            for i, key in enumerate(own):
                rank = i + sum(int(np.searchsorted(lists[o], key, "left"))
                               for o in range(cluster) if o != r)
                if rank < k:
                    out_d[qi, rank] = np.uint32(key >> np.uint64(32)).view(np.float32)
                    out_i[qi, rank] = cand[qi, int(key & np.uint64(0xFFFFFFFF))]
    return out_d, out_i


def _plain_dists(q, x, cand):
    """The plain version's (B, P) distances by difference (as
    ref.ivf_scan_ref sums them), +inf at -1 slots."""
    qt, xt, ct = _t(q), _t(x), _t(cand).long()
    diff = xt[torch.clamp_min(ct, 0)] - qt[:, None, :]
    d = torch.sum(diff * diff, dim=-1)
    return torch.where(ct >= 0, d, torch.full_like(d, float("inf"))).numpy()


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


def _case(seed, b, n, p, d, *, ints=False, minus=0.3, dup_rows=0, tomb=0.0):
    """Queries, catalog, table and liveness: `ints` makes every distance
    exact (ties abound), `minus` of the slots are -1, `dup_rows` catalog
    rows repeat row 0 (equal distances under different ids), `tomb` of the
    rows are tombstoned; P > N repeats ids in a row."""
    rng = np.random.default_rng(seed)
    if ints:
        x = rng.integers(-3, 4, (n, d)).astype(np.float32)
        q = rng.integers(-3, 4, (b, d)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        q = rng.normal(size=(b, d)).astype(np.float32)
    if dup_rows:
        x[1:1 + dup_rows] = x[0]
    cand = rng.integers(0, n, (b, p)).astype(np.int32)
    cand[rng.random((b, p)) < minus] = -1
    valid = rng.random(n) >= tomb
    return q, x, cand, valid


# (seed, B, N, P, D, k, case options): the IVF-PQ re-rank's table cut small
# (P 256, one block), ragged P, k > P, k 160 / 400 / 1024, tables that
# take a cluster (P > IVF_PASS) and a cluster whose runs take two passes
# (P > 16 IVF_PASS), exact ties on small integers, duplicated rows, dense
# duplicate ids (P > N), tombstones
CASES = [
    (0, 8, 2000, 256, 16, 64, {}),
    (1, 5, 300, 37, 8, 10, {"tomb": 0.2}),
    (2, 3, 400, 256, 8, 400, {"tomb": 0.1}),            # k > P
    (3, 4, 3000, 1500, 12, 160, {"tomb": 0.1}),         # a cluster of 2
    (4, 2, 5000, 3000, 8, 1024, {}),                   # k at the cap, a cluster of 3
    (5, 3, 1000, 9000, 16, 64, {"ints": True, "minus": 0.05}),   # ties, P > N
    (6, 2, 500, 4000, 8, 400, {"ints": True, "dup_rows": 40}),
    (7, 2, 3000, 20000, 4, 128, {"tomb": 0.05}),        # 16 blocks, two passes each
    (8, 6, 50, 700, 8, 10, {"dup_rows": 10, "minus": 0.0}),
    (9, 4, 200, 64, 8, 1, {"minus": 1.0}),               # every slot -1
]


@pytest.mark.parametrize("seed,b,n,p,d,k,opts", CASES)
def test_selection_emulation_gives_the_plain_version_bit_for_bit(seed, b, n, p, d, k, opts):
    q, x, cand, valid = _case(seed, b, n, p, d, **opts)
    v = valid if opts.get("tomb") else None
    dist = _plain_dists(q, x, cand)
    gd, gi = emulate(dist, cand, k, n, v)
    wd, wi = tref.ivf_scan_ref(_t(q), _t(x), _t(cand), k, None if v is None else _t(v))
    np.testing.assert_array_equal(gd, wd.numpy())
    np.testing.assert_array_equal(gi, wi.numpy())
    if v is not None:
        assert not np.isin(gi, np.flatnonzero(~valid)).any()


@pytest.mark.parametrize("seed,b,n,p,d,k,opts", CASES)
def test_selection_emulation_matches_the_jax_reference(seed, b, n, p, d, k, opts):
    q, x, cand, valid = _case(seed, b, n, p, d, **opts)
    v = valid if opts.get("tomb") else None
    gd, gi = emulate(_plain_dists(q, x, cand), cand, k, n, v)
    jq, jx, jc = jnp.array(q), jnp.array(x), jnp.array(cand)
    jv = None if v is None else jnp.array(v)
    if k <= 128 and p <= 4096:  # the Pallas kernel, in interpret mode
        wd, wi = jops.ivf_scan_topk(jq, jx, jc, k, valid=jv, interpret=True)
    else:
        if jv is not None:
            jc = jnp.where((jc >= 0) & jv[jnp.clip(jc, 0, n - 1)], jc, -1)
        wd, wi = jref.ivf_scan_ref(jq, jx, jc, k)
    _check_topk(gd, gi, wd, wi, scale=(36.0 if opts.get("ints") else 4.0) * d)


@pytest.mark.parametrize("cluster", [1, 2, 5, 16])
def test_any_cluster_split_selects_the_same(cluster):
    """The merge by rank is exact for any split of the table: one block
    walking it in passes, or runs over 2, 5 or 16 blocks."""
    q, x, cand, _ = _case(11, 3, 800, 2500, 8, ints=True)
    dist = _plain_dists(q, x, cand)
    run = -(-2500 // cluster)
    got = emulate(dist, cand, 200, 800, plan=(cluster, run, cluster))
    want = emulate(dist, cand, 200, 800)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_bitonic_network_sorts():
    rng = np.random.default_rng(3)
    for n in (2, 64, 512, 2048):
        keys = rng.integers(0, 2 ** 63, n, dtype=np.uint64)
        keys[rng.random(n) < 0.2] = EMPTY
        np.testing.assert_array_equal(bitonic_sort(keys), np.sort(keys))


def test_keys_order_distances_then_positions():
    """Non-negative float32 bits order as unsigned integers, +inf above every
    finite one, and the low word breaks ties by position."""
    d = np.array([0.0, 1e-30, 0.5, 0.5, 3.0, 1e30, np.inf], np.float32)
    bits = d.view(np.uint32).astype(np.uint64)
    keys = (bits << np.uint64(32)) | np.array([9, 8, 7, 2, 1, 0, 0], np.uint64)
    assert list(np.argsort(keys, kind="stable")) == [0, 1, 3, 2, 4, 5, 6]


@pytest.mark.parametrize("k", [1, 10, 64, 128, 160, 400, 1024])
@pytest.mark.parametrize("b,p", [(1, 66320), (8, 66320), (64, 256), (8, 256), (3, 9000),
                                 (2, 1025)])
def test_plan_tiles_the_table_in_clusters_that_fit(b, p, k):
    blocks, run, cluster = tops.ivf_scan_plan(b, p, k)
    assert blocks == cluster and 1 <= cluster <= tops.IVF_MAX_CLUSTER
    assert (cluster - 1) * run < p <= cluster * run
    assert cluster == 1 or run >= -(-p // tops.IVF_MAX_CLUSTER)
    # the kept keys (k rounded up to a power of two) and a pass's new ones
    # fit the key buffer, and the block's shared memory fits at D 128 / 4096
    assert _pow2(k) + tops.IVF_PASS <= 2 * tops.IVF_PASS
    for d in (128, 4096):
        assert tops.ivf_scan_smem_bytes_host(d) <= tops.SMEM_LIMIT


def test_plan_refuses_k_past_the_cap():
    with pytest.raises(NotImplementedError):
        tops.ivf_scan_plan(8, 256, tops.MAX_K + 1)
    with pytest.raises(ValueError):
        tops.ivf_scan_plan(8, 256, 0)
