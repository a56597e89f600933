"""Port parity, core math: repro_torch.core vs the JAX reference repro.core.

Inputs are made with numpy from a seed and fed to both.  Tolerances:
float outputs agree to rtol 1e-5 and atol 1e-5 times the scale of the
values (sorts, cumsums and reductions run in another order in XLA and
PyTorch, so the last float32 bits may differ); discrete outputs (x, ids,
served flags) must match exactly.  No bitwise demand on floats: the
reference itself fails last-ulp pins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_instance
from repro.core import costs as jcosts
from repro.core import gain as jgain
from repro.core import mirror as jmirror
from repro.core import oma as joma
from repro.core import projection as jproj
from repro.core import rounding as jround
from repro_torch.core import costs as tcosts
from repro_torch.core import gain as tgain
from repro_torch.core import mirror as tmirror
from repro_torch.core import oma as toma
from repro_torch.core import projection as tproj
from repro_torch.core import rounding as tround

RTOL = 1e-5


def _close(got, want, scale=1.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=1e-5 * scale)


def _t(a):
    return torch.from_numpy(np.array(a))


def _feasible_y(rng, n, h):
    z = rng.random(n)
    z = np.minimum(z / z.sum() * h, 1.0)
    for _ in range(8):
        z = np.clip(z + (h - z.sum()) * (1 - z) / max((1 - z).sum(), 1e-9), 0, 1)
    return z.astype(np.float32)


@pytest.mark.parametrize("seed", range(6))
def test_negentropy_projection_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(10, 400))
    h = int(rng.integers(1, n))
    z = (rng.random(n) ** 3 * rng.choice([0.1, 1, 10])).astype(np.float32) + 1e-8
    want = np.asarray(jproj.capped_simplex_negentropy(jnp.array(z), h))
    _close(tproj.capped_simplex_negentropy(_t(z), h), want)
    a = min(n, h + 16)
    want_a = np.asarray(jproj.capped_simplex_negentropy_topk(jnp.array(z), h, a))
    _close(tproj.capped_simplex_negentropy_topk(_t(z), h, a), want_a)


def test_negentropy_topk_degenerate_z_matches_reference():
    # fewer than h positive entries (heavy removal leaves little live mass)
    z = np.zeros(50, np.float32)
    z[:3] = [0.5, 0.2, 0.1]
    want = np.asarray(jproj.capped_simplex_negentropy_topk(jnp.array(z), 10, 20))
    _close(tproj.capped_simplex_negentropy_topk(_t(z), 10, 20), want)


@pytest.mark.parametrize("n", [1, 1023, 1025, 5000, 70001])
def test_suffix_sum_in_a_fixed_order(n):
    """The projection's suffix sums (rows of 1024 scanned apart, then the
    rows' totals; never PyTorch's 1-D scan, which on CUDA adds in a
    timing-dependent order): within float32 rounding of the float64 sums,
    and the projection over several rows still the reference's."""
    rng = np.random.default_rng(n)
    v = np.sort(rng.random(n).astype(np.float32) ** 3)[::-1].copy()
    want = np.cumsum(v[::-1].astype(np.float64))[::-1]
    got = tproj.suffix_sum(_t(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=4e-7 * np.log2(n + 2), atol=0)
    h = max(1, n // 10)
    _close(tproj.capped_simplex_negentropy(_t(v), h),
           np.asarray(jproj.capped_simplex_negentropy(jnp.array(v), h)))


@pytest.mark.parametrize("seed", range(4))
def test_euclidean_projection_matches_reference(seed):
    rng = np.random.default_rng(50 + seed)
    n = int(rng.integers(10, 400))
    h = int(rng.integers(1, n))
    z = rng.normal(0, 1, n).astype(np.float32)
    want = np.asarray(jproj.capped_simplex_euclidean(jnp.array(z), h))
    _close(tproj.capped_simplex_euclidean(_t(z), h), want)


@pytest.mark.parametrize("mirror", ["negentropy", "euclidean"])
def test_dual_ascent_step_matches_reference(mirror):
    rng = np.random.default_rng(1)
    y = rng.random(64).astype(np.float32)
    g = (rng.normal(0, 1, 64) * 50).astype(np.float32)  # eta*g hits the clip
    want = np.asarray(jmirror.dual_ascent_step(jnp.array(y), jnp.array(g), 2.0, mirror))
    got = tmirror.dual_ascent_step(_t(y), _t(g), 2.0, mirror)
    _close(got, want, scale=float(np.abs(want).max()))


@pytest.mark.parametrize("mirror,topk", [("negentropy", 0), ("negentropy", 40),
                                         ("euclidean", 0)])
def test_oma_update_matches_reference(mirror, topk):
    rng = np.random.default_rng(2)
    n, h = 300, 20
    y = _feasible_y(rng, n, h)
    g = (rng.random(n) * (rng.random(n) < 0.1)).astype(np.float32)
    jc = joma.OMAConfig(eta=0.7, mirror=mirror, projection_topk=topk)
    tc = toma.OMAConfig(eta=0.7, mirror=mirror, projection_topk=topk)
    want = np.asarray(joma.oma_update(jnp.array(y), jnp.array(g), h, jc))
    _close(toma.oma_update(_t(y), _t(g), h, tc), want)
    _close(toma.uniform_state(n, h, device="cpu"), joma.uniform_state(n, h))
    assert toma.Y_FLOOR == joma.Y_FLOOR


@pytest.mark.parametrize("n,h", [(32, 5), (100, 20), (7, 3), (2000, 64)])
def test_depround_equals_reference_with_its_uniforms(n, h):
    rng = np.random.default_rng(n)
    y = _feasible_y(rng, n, h)
    for s in range(3):
        key = jax.random.PRNGKey(s)
        u = np.asarray(jax.random.uniform(key, (n - 1,)))
        want = np.asarray(jround.depround(key, jnp.array(y)))
        got = tround.depround(u, _t(y)).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.sum() == h


def test_coupled_and_independent_rounding_equal_reference():
    rng = np.random.default_rng(3)
    n, h = 500, 40
    y0 = _feasible_y(rng, n, h)
    y1 = np.clip(y0 + rng.normal(0, 0.08, n).astype(np.float32), 0.01, 0.99)
    x0 = np.asarray(jround.depround(jax.random.PRNGKey(9), jnp.array(y0)))
    for s in range(3):
        key = jax.random.PRNGKey(100 + s)
        u = np.asarray(jax.random.uniform(key, (n,), dtype=jnp.float32))
        want = np.asarray(jround.coupled_rounding(key, jnp.array(x0), jnp.array(y0),
                                                  jnp.array(y1)))
        got = tround.coupled_rounding(_t(u), _t(x0), _t(y0), _t(y1)).numpy()
        np.testing.assert_array_equal(got, want)
        want_i = np.asarray(jround.independent_rounding(key, jnp.array(y1)))
        np.testing.assert_array_equal(tround.independent_rounding(_t(u), _t(y1)).numpy(),
                                      want_i)
    assert float(tround.movement(_t(y1 > 0.5).float(), _t(x0))) == float(
        jround.movement(jnp.array(y1 > 0.5, jnp.float32), jnp.array(x0)))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k", [1, 4, 7])
def test_gain_subgradient_serve_match_reference(seed, k):
    rng = np.random.default_rng(seed)
    d, y, x, _, c_f = make_instance(rng, n=30, k=k)
    dj, yj, xj = jnp.array(d), jnp.array(y), jnp.array(x)
    _close(tgain.gain_value(_t(d), _t(y), k, c_f), jgain.gain_value(dj, yj, k, c_f),
           scale=k * c_f)
    gw, sw = jgain.gain_and_subgradient(dj, yj, k, c_f)
    gg, sg = tgain.gain_and_subgradient(_t(d), _t(y), k, c_f)
    _close(gg, gw, scale=k * c_f)
    _close(sg, sw, scale=2.0 + c_f)
    rw = jgain.serve(dj, xj, k, c_f)
    rg = tgain.serve(_t(d), _t(x), k, c_f)
    np.testing.assert_array_equal(rg.answer_ids.numpy(), np.asarray(rw.answer_ids))
    np.testing.assert_array_equal(rg.from_cache.numpy(), np.asarray(rw.from_cache))
    _close(rg.answer_costs, rw.answer_costs, scale=2.0 + c_f)
    _close(rg.cost, rw.cost, scale=k * (2.0 + c_f))
    _close(rg.gain, rw.gain, scale=k * c_f)


def test_batched_gain_with_padded_and_duplicate_slots():
    """B = 8 slabs with BIG_COST / zero-weight invalid slots (their tie
    order decides lpos and rpos) and fewer than k valid entries."""
    from repro.core.costs import BIG_COST

    rng = np.random.default_rng(11)
    b, c, k, c_f = 8, 24, 6, 0.6
    d = (rng.random((b, c)) * 2).astype(np.float32)
    invalid = rng.random((b, c)) < 0.4
    invalid[0, 3:] = True  # under k valid slots
    d[invalid] = BIG_COST
    y = np.where(invalid, 0, rng.random((b, c))).astype(np.float32)
    x = np.where(invalid, 0, rng.random((b, c)) < 0.5).astype(np.float32)
    gw, sw = jgain.gain_and_subgradient_batch(jnp.array(d), jnp.array(y), k, c_f)
    gg, sg = tgain.gain_and_subgradient_batch(_t(d), _t(y), k, c_f)
    _close(gg, gw, scale=k * c_f)
    _close(sg, sw, scale=2.0 + c_f)
    rw = jgain.serve_batch(jnp.array(d), jnp.array(x), k, c_f)
    rg = tgain.serve_batch(_t(d), _t(x), k, c_f)
    np.testing.assert_array_equal(rg.answer_ids.numpy(), np.asarray(rw.answer_ids))
    np.testing.assert_array_equal(rg.from_cache.numpy(), np.asarray(rw.from_cache))
    _close(rg.gain, rw.gain, scale=k * c_f)
    _close(tgain.gain_value_batch(_t(d), _t(x), k, c_f),
           jgain.gain_value_batch(jnp.array(d), jnp.array(x), k, c_f), scale=k * c_f)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "ip"])
def test_pairwise_dissimilarity_matches_reference(metric):
    rng = np.random.default_rng(5)
    q = rng.random((7, 16)).astype(np.float32)
    p = rng.random((40, 16)).astype(np.float32)
    want = np.asarray(jcosts.pairwise_dissimilarity(jnp.array(q), jnp.array(p), metric))
    _close(tcosts.pairwise_dissimilarity(_t(q), _t(p), metric), want, scale=16.0)
    assert tcosts.BIG_COST == float(jcosts.BIG_COST)


def test_calibrate_fetch_cost_matches_reference_with_its_sample():
    rng = np.random.default_rng(6)
    cat = rng.random((600, 16)).astype(np.float32)
    sample, kth = 128, 50
    idx = np.asarray(jax.random.choice(jax.random.PRNGKey(0), 600, shape=(sample,),
                                       replace=False))
    want = float(jcosts.calibrate_fetch_cost(jnp.array(cat), kth=kth, sample=sample))
    got = tcosts.calibrate_fetch_cost(cat, kth=kth, idx=idx, device="cpu")
    assert got == pytest.approx(want, rel=RTOL)
