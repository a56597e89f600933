"""Port parity, the per-request helpers and the two bounds (ROADMAP A13):
`policy.per_request_view` / `exact_candidate_fn`,
`candidates.index_candidate_fn`, `gain.empty_cache_cost` /
`lower_bound_l` and `oma.theoretical_eta`, each against the reference in
one process at a few seeds, and the exports of `repro_torch.core`.

Tolerances: distances and costs rtol = atol = 1e-5 (x the distance scale
for distances), ids and validity equal; the bound L to 1e-5 relative;
eta* to 1e-12 relative (both packages compute it in Python floats).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from conftest import make_instance
from repro.core import gain as JG
from repro.core import oma as joma
from repro.core import policy as jpolicy
from repro.core import rounding as jround
from repro.core import trace as jtrace
from repro.index import candidates as jcand
from repro.index.exact import FlatIndex as JFlat
from repro.index.ivf import IVFFlatIndex as JIVF
from repro_torch import convert
from repro_torch.core import gain as TG
from repro_torch.core import oma as toma
from repro_torch.core import policy as tpolicy
from repro_torch.index import candidates as tcand
from repro_torch.index.exact import FlatIndex as TFlat

SEEDS = [0, 1, 2]


def _t(a):
    return torch.from_numpy(np.array(a))


def _catalog(seed):
    cat, reqs, _ = jtrace.amazon_like(n=600, d=16, t=8, clusters=8, seed=seed)
    h = 32
    y = np.full(cat.shape[0], h / cat.shape[0], np.float32)
    x = np.asarray(jround.depround(jax.random.PRNGKey(seed), jnp.array(y)))
    return cat, reqs, x, h


def _same_slab(got, want, scale=10.0):
    gi, gd, gv = (a.numpy() for a in got)
    wi, wd, wv = (np.asarray(a) for a in want)
    assert gi.shape == wi.shape and gi.ndim == 1
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("seed", SEEDS)
def test_exact_candidate_fn_is_the_batched_generators_one_request_view(seed):
    cat, reqs, x, _ = _catalog(seed)
    jfn = jpolicy.exact_candidate_fn(jnp.array(cat), 24, 12)
    tfn = tpolicy.exact_candidate_fn(_t(cat), 24, 12)
    batched = tpolicy.exact_candidate_fn_batched(_t(cat), 24, 12)
    for r in reqs[:3]:
        got = tfn(_t(r), _t(x))
        _same_slab(got, jfn(jnp.array(r), jnp.array(x)))
        for a, b in zip(got, batched(_t(r)[None], _t(x))):
            assert torch.equal(a, b[0])


def test_per_request_view_keeps_local_cap():
    def fn(rs, x):
        return rs, rs, rs

    fn.local_cap = 7
    assert tpolicy.per_request_view(fn).local_cap == 7
    assert not hasattr(tpolicy.per_request_view(lambda rs, x: (rs, rs, rs)), "local_cap")


@pytest.mark.parametrize("backend", ["flat", "ivf"])
@pytest.mark.parametrize("seed", SEEDS)
def test_index_candidate_fn_matches_reference(seed, backend):
    cat, reqs, x, h = _catalog(seed)
    if backend == "flat":
        jidx, tidx = JFlat(jnp.array(cat), kernel="xla"), TFlat(cat, device="cpu")
    else:
        jidx = JIVF(jnp.array(cat), nlist=8, nprobe=3, train_iters=4)
        tidx = convert.ivf_from_numpy(cat, np.asarray(jidx.centroids),
                                      np.asarray(jidx.invlists), 3, device="cpu")
    jfn = jcand.index_candidate_fn(jidx, jnp.array(cat), 24, 12, h=h)
    tfn = tcand.index_candidate_fn(tidx, _t(cat), 24, 12, h=h)
    for r in reqs[:3]:
        _same_slab(tfn(_t(r), _t(x)), jfn(jnp.array(r), jnp.array(x)))


@pytest.mark.parametrize("seed", SEEDS + [3, 4])
def test_empty_cache_cost_and_lower_bound_match_reference(seed):
    rng = np.random.default_rng(seed)
    d, y, _, k, c_f = make_instance(rng)
    want = float(JG.empty_cache_cost(jnp.array(d), k, c_f))
    got = TG.empty_cache_cost(_t(d), k, c_f)
    assert got.shape == ()
    assert float(got) == pytest.approx(want, rel=1e-5, abs=1e-5)
    want_l = float(JG.lower_bound_l(jnp.array(d), jnp.array(y), k, c_f))
    got_l = float(TG.lower_bound_l(_t(d), _t(y), k, c_f))
    assert got_l == pytest.approx(want_l, rel=1e-5, abs=1e-6)
    # Lemma 1 on the port's own values
    g = float(TG.gain_value(_t(d), _t(y), k, c_f))
    assert got_l <= g + 1e-4
    assert g <= got_l / (1 - 1 / np.e) + 1e-3


@pytest.mark.parametrize("args", [(1.0, 0.5, 400, 1_000_000, 20_000), (2.5, 1.0, 10, 5, 1),
                                  (0.1, 0.0, 0, 100, 0), (3.0, 2.0, 64, 64, 1000)])
def test_theoretical_eta_matches_reference(args):
    assert toma.theoretical_eta(*args) == pytest.approx(joma.theoretical_eta(*args),
                                                        rel=1e-12)


def test_core_exports_match_the_reference():
    assert sorted(tcore.__all__) == sorted(jcore.__all__)
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None, name
