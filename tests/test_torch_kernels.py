"""Port parity, kernels: the plain versions in repro_torch.kernels (what the
wrappers run on CPU tensors) against the JAX reference oracles and the
reference's Pallas kernels in interpret mode, as tests/test_kernels.py runs
them.  The CUDA kernels themselves run only on the card (chip_smoke.py
holds each against its plain version there).

Tolerances: distances agree to rtol 1e-5, atol 1e-5 x the distance scale
(the sums run in another order); ids must be equal wherever the
reference's margin between neighbouring distances exceeds that tolerance
(ties and near-ties may legitimately swap), and -1 underflow slots must
land in the same places.
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


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_topk(gd, gi, wd, wi, scale):
    gd, gi, wd, wi = (np.asarray(a) for a in (gd, gi, wd, wi))
    tol = 1e-5 * scale
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=tol)
    np.testing.assert_array_equal(gi == -1, wi == -1)
    # a slot's id is decided where its distance is apart from both
    # neighbours by more than the tolerance
    finite = np.where(np.isfinite(wd), wd, 1e30)
    gap = np.diff(finite, axis=1)
    left = np.concatenate([np.full((wd.shape[0], 1), np.inf), gap], axis=1)
    right = np.concatenate([gap, np.full((wd.shape[0], 1), np.inf)], axis=1)
    decided = (left > tol + RTOL * np.abs(finite)) & (right > tol + RTOL * np.abs(finite))
    np.testing.assert_array_equal(gi[decided], wi[decided])


@pytest.mark.parametrize("q,n,d", [(4, 100, 16), (37, 513, 24), (1, 2000, 32),
                                   (130, 129, 8)])
def test_pairwise_l2_plain_matches_reference(q, n, d):
    rng = np.random.default_rng(0)
    qa = rng.normal(size=(q, d)).astype(np.float32)
    xa = rng.normal(size=(n, d)).astype(np.float32)
    got = tops.pairwise_l2(_t(qa), _t(xa)).numpy()
    want = np.asarray(jref.pairwise_l2_ref(jnp.array(qa), jnp.array(xa)))
    scale = 4.0 * d
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5 * scale)
    pallas = np.asarray(jops.pairwise_l2(jnp.array(qa), jnp.array(xa), interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=1e-5 * scale)
    assert (got >= 0).all()


@pytest.mark.parametrize("k", [1, 10, 64, 128])
@pytest.mark.parametrize("q,n,d", [(5, 300, 16), (9, 517, 24)])
def test_topk_l2_plain_matches_reference(q, n, d, k):
    rng = np.random.default_rng(1)
    qa = rng.normal(size=(q, d)).astype(np.float32)
    xa = rng.normal(size=(n, d)).astype(np.float32)
    gd, gi = tops.topk_l2(_t(qa), _t(xa), k)
    assert gi.dtype == torch.int32
    wd, wi = jref.l2_topk_ref(jnp.array(qa), jnp.array(xa), k)
    _check_topk(gd, gi, wd, wi, scale=4.0 * d)
    pd, pi = jops.topk_l2(jnp.array(qa), jnp.array(xa), k, interpret=True)
    _check_topk(gd, gi, pd, pi, scale=4.0 * d)


@pytest.mark.parametrize("k", [1, 10, 64])
def test_topk_l2_tombstones_underflow_to_minus_one(k):
    rng = np.random.default_rng(2)
    qa = rng.normal(size=(6, 16)).astype(np.float32)
    xa = rng.normal(size=(200, 16)).astype(np.float32)
    valid = np.zeros(200, bool)
    valid[rng.choice(200, size=30, replace=False)] = True  # 30 live rows
    gd, gi = tops.topk_l2(_t(qa), _t(xa), k, valid=_t(valid))
    wd, wi = jref.l2_topk_ref(jnp.array(qa), jnp.array(xa), k, valid=jnp.array(valid))
    _check_topk(gd, gi, wd, wi, scale=64.0)
    pd, pi = jops.topk_l2(jnp.array(qa), jnp.array(xa), k, valid=jnp.array(valid),
                          interpret=True)
    _check_topk(gd, gi, pd, pi, scale=64.0)
    assert (gi.numpy() >= 0).sum(axis=1).max() <= 30
    assert valid[gi.numpy()[gi.numpy() >= 0]].all()


def test_topk_l2_ties_take_the_lowest_id():
    xa = np.zeros((50, 8), np.float32)
    xa[::2] = 1.0  # 25 rows tied at distance 0 from the zero query
    gd, gi = tops.topk_l2(torch.zeros((1, 8)), _t(xa), 10)
    np.testing.assert_array_equal(gi.numpy()[0], np.arange(1, 20, 2))
    wd, wi = jref.l2_topk_ref(jnp.zeros((1, 8)), jnp.array(xa), 10)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("k", [1, 10, 64, 128])
@pytest.mark.parametrize("b,n,p,d", [(4, 200, 64, 16), (5, 300, 37, 16),
                                     (8, 500, 300, 32)])
def test_ivf_scan_plain_matches_reference(b, n, p, d, k):
    """-1 slots, duplicates, ragged P and k > P (padded with +inf / -1)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    cand = rng.integers(0, n, (b, p)).astype(np.int32)
    cand[rng.random((b, p)) < 0.3] = -1
    gd, gi = tops.ivf_scan_topk(_t(q), _t(x), _t(cand), k)
    assert gi.dtype == torch.int32 and gd.shape == (b, k)
    wd, wi = jref.ivf_scan_ref(jnp.array(q), jnp.array(x), jnp.array(cand), k)
    _check_topk(gd, gi, wd, wi, scale=4.0 * d)
    pd, pi = jops.ivf_scan_topk(jnp.array(q), jnp.array(x), jnp.array(cand), k,
                                interpret=True)
    _check_topk(gd, gi, pd, pi, scale=4.0 * d)


def test_ivf_scan_tombstones_fold_to_minus_one():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(80, 8)).astype(np.float32)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    cand = np.full((3, 20), -1, np.int32)
    cand[0, :6] = [7, 31, 7, 2, 3, 4]
    cand[1, :] = -1
    cand[2, :] = np.arange(20)
    valid = np.ones(80, bool)
    valid[[3, 4, 5, 31]] = False
    gd, gi = tops.ivf_scan_topk(_t(q), _t(x), _t(cand), 5, valid=_t(valid))
    wd, wi = jops.ivf_scan_topk(jnp.array(q), jnp.array(x), jnp.array(cand), 5,
                                valid=jnp.array(valid), interpret=True)
    _check_topk(gd, gi, wd, wi, scale=32.0)
    assert (gi.numpy()[1] == -1).all()
    assert not np.isin(gi.numpy(), [3, 4, 5, 31]).any()


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The dispatch is by tensor device; on the card k above the kernels'
    cap (ops.MAX_K, 1024) raises instead of hiding the kernel behind a
    plain-version fallback, and every k up to it (129 among them) is taken.
    Checked without a card through the argument checks that run before any
    launch."""
    with pytest.raises(ValueError):
        tops._device(torch.zeros(1), torch.zeros(1, device="meta"))
    assert tops.MAX_K == 1024
    for k in (129, 160, 400, tops.MAX_K):
        tops._check_k("topk_l2", k)
    with pytest.raises(NotImplementedError, match="1024"):
        tops._check_k("topk_l2", tops.MAX_K + 1)
    with pytest.raises(ValueError):
        tops._check_k("topk_l2", 0)
    with pytest.raises(TypeError):
        tops._check("x", torch.zeros(2, 2, dtype=torch.float64), torch.float32, 2)
    with pytest.raises(ValueError):
        tops._check("x", torch.zeros(4, 4).T, torch.float32, 2)
    # the plain versions count no kernel launch
    tops.reset_launches()
    tops.pairwise_l2(torch.zeros(2, 4), torch.zeros(3, 4))
    tops.pq_adc_gather(torch.zeros(2, 2, 4), torch.zeros(3, 2, dtype=torch.uint8),
                       torch.zeros(2, 5, dtype=torch.int32))
    tops.flash_attention(torch.zeros(1, 3, 2, 16), torch.zeros(1, 5, 1, 16),
                         torch.zeros(1, 5, 1, 16))
    tops.pairwise_l2_batched(torch.zeros(2, 3, 4), torch.zeros(2, 5, 4))
    tops.ivf_scan_lists(torch.zeros(2, 4), torch.zeros(6, 4),
                        torch.zeros(3, 2, dtype=torch.int32),
                        torch.zeros(2, 1, dtype=torch.int32), 1)
    tops.pq_shortlist_lists(torch.zeros(2, 2, 4), torch.zeros(3, 2, 2, dtype=torch.uint8),
                            torch.zeros(3, 2, dtype=torch.int32),
                            torch.zeros(2, 1, dtype=torch.int32), 1)
    assert tops.LAUNCHES == {"pairwise_l2": 0, "l2_topk": 0, "ivf_scan": 0,
                             "ivf_scan_lists": 0, "pq_adc": 0, "pq_adc_lists": 0,
                             "flash_attention": 0, "flash_attention_wgmma": 0}
    assert not tops.SHAPE_LAUNCHES


@pytest.mark.parametrize("nq,d,k,want", [
    (8, 128, 64, 1), (32, 128, 64, 2), (64, 128, 64, 4),
    (64, 1024, 16, 4),   # the semantic tier's B = 64 at qwen1.5-0.5b's width
    (512, 1024, 51, 4),  # calibrate_fetch_cost's 512-row sample
    (8, 1024, 16, 1), (64, 2048, 16, 4),
    (64, 4096, 16, 4),   # yi-6b's and minitron-8b's width
    (512, 4096, 51, 4),  # the calibration sample there
    (64, 8192, 16, 4),   # qwen2-72b's width
    (64, 8192, 128, 4)])
def test_l2_topk_takes_the_widest_query_tile_that_fits(nq, d, k, want):
    """qt follows the batch (1, 2, 4) down to what a block's shared memory
    holds; the kernel streams the depth, so a 64-query tile fits at every
    width (checked without a card: the launch plan is host arithmetic over
    `l2_topk_smem_bytes_host`, the host copy of the kernel's smem formula
    that chip_smoke.py holds equal to the library's for every (qt, d, k)
    these cases reach)."""
    smem = tops.l2_topk_smem_bytes_host
    assert tops.topk_l2_query_tile(nq, d, k, smem) == want
    assert smem(4, d, k) == smem(4, 128, k) <= tops.SMEM_LIMIT


def test_l2_topk_query_tile_raises_when_no_tile_fits():
    """The plan halves qt while a tile does not fit and raises when even 16
    queries do not (a shared-memory formula over the limit at every qt)."""
    assert tops.topk_l2_query_tile(64, 128, 16, lambda qt, d, k: 10 ** 5 * qt) == 2
    with pytest.raises(NotImplementedError):
        tops.topk_l2_query_tile(64, 128, 16, lambda qt, d, k: tops.SMEM_LIMIT + 1)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "flash_attention_wgmma"),
    (torch.bfloat16, 128, "flash_attention_wgmma"),
    (torch.bfloat16, 32, "flash_attention"), (torch.bfloat16, 16, "flash_attention"),
    (torch.float32, 64, "flash_attention"), (torch.float32, 128, "flash_attention"),
    (torch.bfloat16, (192, 128), "flash_attention_wgmma"),
    (torch.bfloat16, 80, "flash_attention_wgmma"), (torch.float32, 80, "flash_attention"),
    (torch.bfloat16, (24, 16), "flash_attention"),
    (torch.float32, (192, 128), "flash_attention")])
def test_flash_attention_takes_its_kernel_by_dtype_and_width(dtype, d, want):
    """bf16 at (Dk, Dv) (64, 64), hubert-xlarge's (80, 80) (two 64-column
    TMA boxes, the second zero past column 80), (128, 128) and
    deepseek-v3's (192, 128) goes to the tensor-core kernel; float32 at
    every width, and bf16 at the small check widths, to the float32 FMA
    kernel (float32 is held to 1e-4, which tensor cores cannot promise)."""
    dk, dv = d if isinstance(d, tuple) else (d, d)
    assert tops.flash_kernel_for(dtype, dk, dv) == want
    assert (dk, dv) in tops.FLASH_HEAD_DIMS


@pytest.mark.parametrize("k", [1, 10, 64, 128])
@pytest.mark.parametrize("b,p", [(1, 66320), (8, 66320), (64, 66320), (3, 9000)])
def test_ivf_scan_chunks_leave_the_selection_to_the_kernel(b, p, k):
    """The launch plan of a long table (`ivf_scan_plan`, host arithmetic):
    the query's blocks form one cluster of at most IVF_MAX_CLUSTER whose
    runs tile P, each run at least IVF_MIN_RUN slots, so the kernel selects
    the final k itself (no partials left for the wrapper to merge)."""
    blocks, run, cluster = tops.ivf_scan_plan(b, p, k)
    assert blocks == cluster == tops.IVF_MAX_CLUSTER
    assert (cluster - 1) * run < p <= cluster * run
    assert run >= tops.IVF_MIN_RUN
    assert (run > tops.IVF_PASS) == (p > tops.IVF_MAX_CLUSTER * tops.IVF_PASS)


def test_plain_versions_keep_reference_conventions():
    # clamp at 0 on identical points; k > P pads with +inf / -1
    x = np.random.default_rng(6).normal(size=(10, 8)).astype(np.float32)
    d = tref.pairwise_l2_ref(_t(x), _t(x)).numpy()
    assert (d >= 0).all()
    np.testing.assert_allclose(np.diag(d), 0.0, atol=1e-4)
    gd, gi = tref.ivf_scan_ref(_t(x[:2]), _t(x), torch.tensor([[1, 2], [3, -1]]), 4)
    assert np.isinf(gd.numpy()[0, 2:]).all() and (gi.numpy()[1, 1:] == -1).all()


# The CUDA kernel's numerics (csrc/l2_topk.cu), emulated in plain torch: each
# operand split into a TF32 high part and a TF32 remainder (10-bit
# mantissas, rounded to nearest with ties away, as cvt.rna.tf32.f32); in
# each 64-deep chunk, every 8-deep product summed exactly and added to a
# fresh float32 partial rounded toward zero (the tensor cores' accumulate),
# first the q_lo.x_hi and q_hi.x_lo of all k-steps, then the q_hi.x_hi;
# the partial added to the running float32 dot with a rounded add; then
# the norm epilogue.  The check is chip_smoke.py's
# `compare`: |err| <= 1e-5 x scale, equal -1 / +inf patterns, and equal ids
# wherever the plain version's neighbours are farther apart than that.
def _tf32(a):
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _add_toward_zero(acc, exact):
    s = acc.double() + exact
    r = s.float()
    return torch.where(r.double().abs() > s.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def _l2_topk_3xtf32(q, x, k, valid=None):
    qh, xh = _tf32(q), _tf32(x)
    ql, xl = _tf32(q - qh), _tf32(x - xh)
    dot = torch.zeros(q.shape[0], x.shape[0])
    for c0 in range(0, q.shape[1], 64):
        steps = [slice(k0, k0 + 8) for k0 in range(c0, min(q.shape[1], c0 + 64), 8)]
        terms = [t for s in steps for t in ((ql, xh, s), (qh, xl, s))]
        part = torch.zeros_like(dot)
        for a, b, s in terms + [(qh, xh, s) for s in steps]:
            part = _add_toward_zero(part, a[:, s].double() @ b[:, s].double().T)
        dot = dot + part
    qn = torch.sum(q * q, dim=1, keepdim=True)
    xn = torch.sum(x * x, dim=1)[None, :]
    d = torch.clamp_min(qn - 2.0 * dot + xn, 0.0)
    if valid is not None:
        d = torch.where(valid[None, :], d, torch.full_like(d, float("inf")))
    vals, idx = tref.smallest_k(d, k)
    idx = torch.where(torch.isfinite(vals), idx, torch.full_like(idx, -1))
    return vals, idx.to(torch.int32)


def _compare(gd, gi, wd, wi):
    fin = torch.isfinite(wd)
    assert torch.equal(torch.isfinite(gd), fin)
    scale = max(1.0, float(wd[fin].abs().max())) if bool(fin.any()) else 1.0
    tol = 1e-5 * scale
    if bool(fin.any()):
        assert float((gd[fin] - wd[fin]).abs().max()) <= tol
    assert torch.equal(gi == -1, wi == -1)
    w = torch.where(fin, wd, torch.full_like(wd, 1e30))
    gap = w[:, 1:] - w[:, :-1]
    inf = torch.full_like(w[:, :1], float("inf"))
    margin = torch.minimum(torch.cat([inf, gap], 1), torch.cat([gap, inf], 1))
    decided = margin > tol + 1e-5 * w.abs()
    assert torch.equal(gi[decided], wi[decided])


def _sift_like(n, d):
    from repro_torch.core import trace
    cat, reqs, _ = trace.sift_like(n=n, d=d, t=64, seed=0)
    return torch.from_numpy(reqs), torch.from_numpy(cat)


@pytest.mark.parametrize("k", [10, 64])
@pytest.mark.parametrize("n,d", [(3000, 128), (500, 1024)])
def test_3xtf32_numerics_keep_the_ids_on_the_sift_like_trace(n, d, k):
    """Requests are catalog rows (distance 0 to themselves), the values lie
    in [0, 1): the norms are large against the nearest distances, the
    case where a product's error shows most."""
    q, x = _sift_like(n, d)
    gd, gi = _l2_topk_3xtf32(q, x, k)
    wd, wi = tref.l2_topk_ref(q, x, k)
    _compare(gd, gi, wd, wi)
    jd, ji = jref.l2_topk_ref(jnp.array(q.numpy()), jnp.array(x.numpy()), k)
    _compare(gd, gi, _t(jd), _t(ji))


def test_3xtf32_numerics_break_ties_as_the_plain_version():
    """Small integers are exact in TF32 (no remainder), so every distance is
    exact and ties abound: values and ids equal the plain version's."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.integers(-3, 4, (3, 16)).astype(np.float32))
    x = torch.from_numpy(rng.integers(-3, 4, (1000, 16)).astype(np.float32))
    for k in (1, 10, 64, 128):
        gd, gi = _l2_topk_3xtf32(q, x, k)
        wd, wi = tref.l2_topk_ref(q, x, k)
        assert torch.equal(gd, wd) and torch.equal(gi, wi)


def test_3xtf32_numerics_keep_tombstones_out():
    q, x = _sift_like(3000, 128)
    valid = torch.from_numpy(np.random.default_rng(9).random(3000) < 0.015)  # ~45 live
    gd, gi = _l2_topk_3xtf32(q, x, 64, valid)
    wd, wi = tref.l2_topk_ref(q, x, 64, valid)
    _compare(gd, gi, wd, wi)
    assert bool((gi == -1).any()) and bool(valid[gi[gi >= 0].long()].all())


@pytest.mark.parametrize("nq,n,d,k", [(8, 1_000_000, 128, 64), (64, 1_000_000, 128, 64),
                                      (512, 1_000_000, 1024, 51), (3, 1000, 16, 10),
                                      (64, 130, 4096, 16)])
def test_l2_topk_plan_tiles_the_catalog_in_about_one_wave(nq, n, d, k):
    qt, chunk, nchunks = tops.topk_l2_plan(nq, n, d, k, tops.l2_topk_smem_bytes_host)
    assert chunk % tops.TOPK_BN == 0
    assert (nchunks - 1) * chunk < n <= nchunks * chunk
    blocks = nchunks * -(-nq // (16 * qt))
    assert blocks <= 2 * 132 + 2 * -(-nq // (16 * qt))


@pytest.mark.parametrize("masked", [False, True])
def test_l2_topk_bound_holds_for_the_kernel_numerics(masked):
    """The sample bound is at least each query's k-th distance as the
    kernel computes it (the 3xTF32 emulation) over the whole catalog, and
    keeps far fewer rows than the catalog; below TOPK_SAMPLE_MIN_N rows
    there is none."""
    rng = np.random.default_rng(10)
    n, d, k = tops.TOPK_SAMPLE_MIN_N, 32, 64
    x = torch.from_numpy(rng.random((n, d), dtype=np.float32))
    q = x[torch.from_numpy(rng.integers(0, n, 8))].clone()
    qn = torch.sum(q * q, dim=1)
    valid = torch.from_numpy(rng.random(n) < 0.5) if masked else None
    bound = tops.topk_l2_bound(q, qn, x, k, valid)
    gd, _ = _l2_topk_3xtf32(q, x, n, valid)
    assert bool((gd[:, k - 1] <= bound).all())
    assert int((gd <= bound[:, None]).sum(1).max()) < n // 20
    assert tops.topk_l2_bound(q, qn, x[:n - 1], k) is None


def test_l2_topk_bound_needs_no_row_norms():
    """The top k lie outside the sample, with norms 2500x the sample's
    largest: the bound, which reads no row's norm, still holds for the
    kernel's numerics, and it is tight: the rows it keeps are the 1000 near
    rows and about the 8 x 64 sample-like rows below the sample's k-th."""
    rng = np.random.default_rng(12)
    n, d, k = tops.TOPK_SAMPLE_MIN_N, 32, 64
    x = rng.random((n, d), dtype=np.float32)
    near = slice(tops.TOPK_SAMPLE, tops.TOPK_SAMPLE + 1000)
    x[near] = 50 + rng.random((1000, d), dtype=np.float32)
    x, q = torch.from_numpy(x), torch.from_numpy(50 + rng.random((4, d), dtype=np.float32))
    bound = tops.topk_l2_bound(q, torch.sum(q * q, dim=1), x, k)
    gd, gi = _l2_topk_3xtf32(q, x, n)
    assert bool((gi[:, :k] >= tops.TOPK_SAMPLE).all() & (gi[:, :k] < near.stop).all())
    assert bool((gd[:, k - 1] <= bound).all())
    assert int((gd <= bound[:, None]).sum(1).max()) < 1000 + 16 * k


def test_tf32_split_rounds_as_the_kernel_and_the_emulation():
    """The wrapper splits the queries as the kernel splits catalog rows
    (cvt.rna.tf32.f32): hi and lo agree bit for bit with the emulation's
    rounding, and hi + lo is the value to 2^-22."""
    a = torch.from_numpy(np.random.default_rng(11).normal(size=(40, 36)).astype(np.float32))
    hi, lo = tops.tf32_split(a * 1000)
    assert torch.equal(hi, _tf32(a * 1000)) and torch.equal(lo, _tf32(a * 1000 - hi))
    assert float(((hi + lo) - a * 1000).abs().max()) <= 2.0 ** -22 * float((a * 1000).abs().max())
    assert torch.equal(tops._tma_ready(a), a)
    padded = tops._tma_ready(a[:, :33].contiguous())
    assert padded.shape == (40, 36) and not padded[:, 33:].any()


@pytest.mark.parametrize("masked", [False, True])
def test_topk_l2_pads_k_beyond_the_catalog(masked):
    """k > N returns k columns on either device: the N rows (the live ones
    under `valid`), then +inf distances with id -1."""
    rng = np.random.default_rng(8)
    q, x = _t(rng.normal(size=(2, 4)).astype(np.float32)), _t(rng.normal(size=(5, 4)).astype(np.float32))
    valid = _t(np.array([True, False, True, True, False])) if masked else None
    gd, gi = tops.topk_l2(q, x, 10, valid=valid)
    live = 3 if masked else 5
    assert gd.shape == gi.shape == (2, 10) and gi.dtype == torch.int32
    assert torch.isfinite(gd[:, :live]).all() and torch.isinf(gd[:, live:]).all()
    assert (gi[:, live:] == -1).all() and (gi[:, :live] >= 0).all()
    d = tref.pairwise_l2_ref(q, x)
    want = torch.sort(d if valid is None else d[:, valid], dim=1, stable=True).values
    assert torch.equal(gd[:, :live], want)
    if masked:
        assert valid[gi[:, :live].long()].all()


def test_launch_shape_keys():
    """The shapes `_count` files l2_topk, pq_adc and the flash kernels
    under (the counts themselves move only on the card)."""
    assert tops.l2_topk_key(8, 1_000_000, 128, 64) == (8, 1_000_000, 128, 64)
    assert tops.pq_adc_key(64, 66448, 8, 256) == (64, 66448, 8, 256)
    # a prompt's prefill into the cache: causal, keys past the prompt masked
    q, kv = (1, 512, 16, 64), (1, 8192, 16, 64)
    assert tops.flash_key(q, kv, True, 0, 512) == (1, 512, 8192, 16, 16, 64, 64,
                                                   "causal+written_upto")
    assert tops.flash_key(q, kv, True, 0, 8192)[-1] == "causal"
    assert tops.flash_key(q, kv, True, 4096, 8192)[-1] == "causal+window"
    assert tops.flash_key((2, 300, 8, 128), (2, 1024, 2, 128), False, 0, 700) == (
        2, 300, 1024, 8, 2, 128, 128, "full+written_upto")
    # deepseek-v3's MLA prefill: v narrower than q and k
    assert tops.flash_key((1, 8000, 128, 192), (1, 8192, 128, 192), True, 0, 8000,
                          128) == (1, 8000, 8192, 128, 128, 192, 128,
                                   "causal+written_upto")
