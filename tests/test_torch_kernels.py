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
    """The dispatch is by tensor device; on the card k > 128 raises instead
    of hiding the kernel behind a plain-version fallback.  Checked without
    a card through the argument checks that run before any launch."""
    with pytest.raises(ValueError):
        tops._on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))
    with pytest.raises(NotImplementedError):
        tops._check_k("topk_l2", 129)
    with pytest.raises(ValueError):
        tops._check_k("topk_l2", 0)
    with pytest.raises(TypeError):
        tops._check("x", torch.zeros(2, 2, dtype=torch.float64), torch.float32, 2)
    with pytest.raises(ValueError):
        tops._check("x", torch.zeros(4, 4).T, torch.float32, 2)
    # the plain versions count no kernel launch
    tops.reset_launches()
    tops.pairwise_l2(torch.zeros(2, 4), torch.zeros(3, 4))
    assert tops.LAUNCHES == {"pairwise_l2": 0, "l2_topk": 0, "ivf_scan": 0}


@pytest.mark.parametrize("k", [1, 10, 64, 128])
@pytest.mark.parametrize("b,p", [(1, 66320), (8, 66320), (64, 66320), (3, 9000)])
def test_ivf_scan_chunks_leave_the_selection_to_the_kernel(b, p, k):
    """The blocks tile P, and each selects its k from IVF_MIN_RUN * k slots
    or more, so the merge sorts far fewer partials than P (checked without
    a card: the launch plan is host arithmetic)."""
    chunk, nchunks = tops.ivf_scan_chunks(b, p, k)
    assert (nchunks - 1) * chunk < p <= nchunks * chunk
    assert chunk >= tops.IVF_MIN_RUN * k
    assert nchunks * k <= p // tops.IVF_MIN_RUN + k


def test_plain_versions_keep_reference_conventions():
    # clamp at 0 on identical points; k > P pads with +inf / -1
    x = np.random.default_rng(6).normal(size=(10, 8)).astype(np.float32)
    d = tref.pairwise_l2_ref(_t(x), _t(x)).numpy()
    assert (d >= 0).all()
    np.testing.assert_allclose(np.diag(d), 0.0, atol=1e-4)
    gd, gi = tref.ivf_scan_ref(_t(x[:2]), _t(x), torch.tensor([[1, 2], [3, -1]]), 4)
    assert np.isinf(gd.numpy()[0, 2:]).all() and (gi.numpy()[1, 1:] == -1).all()
