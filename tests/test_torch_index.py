"""Port parity, index layer: repro_torch.index vs repro.index (static catalog).

The port runs with device="cpu", i.e. through the plain kernel versions.
Tolerances: distances rtol 1e-5, atol 1e-5 x the distance scale; ids and
validity equal wherever the reference's distance margin exceeds that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rounding as jround
from repro.core import trace as jtrace
from repro.index import candidates as jcand
from repro.index.exact import FlatIndex as JFlat
from repro.index.ivf import IVFFlatIndex as JIVF
from repro.index.ivf import build_invlists as j_build_invlists
from repro.index.kmeans import kmeans as jkmeans
from repro_torch import convert
from repro_torch.index import base as tbase
from repro_torch.index import candidates as tcand
from repro_torch.index.exact import FlatIndex as TFlat
from repro_torch.index.ivf import IVFFlatIndex as TIVF
from repro_torch.index.ivf import build_invlists as t_build_invlists
from repro_torch.index.kmeans import kmeans as tkmeans

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


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


@pytest.fixture(scope="module")
def clustered():
    """A clustered catalog (well-separated k-means) and some requests."""
    cat, reqs, _ = jtrace.amazon_like(n=1200, d=16, t=64, clusters=12, seed=3)
    return cat, reqs


def test_flat_index_query_matches_reference(clustered):
    cat, reqs = clustered
    for k in (1, 10, 64):
        wd, wi = JFlat(jnp.array(cat), kernel="xla").query(jnp.array(reqs[:8]), k)
        gd, gi = TFlat(cat, device="cpu").query(_t(reqs[:8]), k)
        _check_topk(gd, gi, wd, wi, scale=10.0)


@pytest.mark.parametrize("nlist,nprobe", [(12, 3), (24, 6)])
def test_ivf_loaded_from_reference_answers_like_it(clustered, nlist, nprobe):
    cat, reqs = clustered
    ref = JIVF(jnp.array(cat), nlist=nlist, nprobe=nprobe, train_iters=4)
    port = convert.ivf_from_numpy(cat, np.asarray(ref.centroids),
                                  np.asarray(ref.invlists), nprobe, device="cpu")
    for b in (1, 8):
        for k in (10, 64):
            wd, wi = ref.query(jnp.array(reqs[:b]), k)
            gd, gi = port.query(_t(reqs[:b]), k)
            _check_topk(gd, gi, wd, wi, scale=10.0)


def test_kmeans_and_ivf_build_match_reference(clustered):
    cat = clustered[0]
    key = jax.random.PRNGKey(0)
    idx = np.asarray(jax.random.choice(key, cat.shape[0], shape=(12,), replace=False))
    wc, wa = jkmeans(key, jnp.array(cat), 12, 4)
    gc, ga = tkmeans(_t(cat), 12, 4, init_idx=idx)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=RTOL, atol=1e-5 * 4)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    # the whole build path: same init rows -> the same inverted lists
    ref = JIVF(jnp.array(cat), nlist=12, nprobe=3, train_iters=4, seed=0)
    port = TIVF(cat, nlist=12, nprobe=3, train_iters=4, init_idx=idx, device="cpu")
    np.testing.assert_array_equal(port.invlists.numpy(), np.asarray(ref.invlists))
    assert port.memory_bytes() == int(port.embeddings.nbytes + port.centroids.nbytes
                                      + port.invlists.nbytes + port.valid.nbytes)


@pytest.mark.parametrize("seed,nlist,cap", [(0, 7, None), (1, 16, None), (2, 5, 30)])
def test_build_invlists_identical_to_reference_loop(seed, nlist, cap):
    assign = np.random.default_rng(seed).integers(0, nlist, 300)
    assign[:3] = 0
    np.testing.assert_array_equal(t_build_invlists(assign, nlist, cap),
                                  j_build_invlists(assign, nlist, cap))


@pytest.mark.parametrize("backend", ["flat", "ivf"])
@pytest.mark.parametrize("b", [1, 8])
def test_index_candidate_slabs_match_reference(clustered, backend, b):
    cat, reqs = clustered
    n, h = cat.shape[0], 48
    y = np.full(n, h / n, np.float32)
    x = np.asarray(jround.depround(jax.random.PRNGKey(1), jnp.array(y)))
    if backend == "flat":
        jidx, tidx = JFlat(jnp.array(cat), kernel="xla"), TFlat(cat, device="cpu")
    else:
        jidx = JIVF(jnp.array(cat), nlist=12, nprobe=4, train_iters=4)
        tidx = convert.ivf_from_numpy(cat, np.asarray(jidx.centroids),
                                      np.asarray(jidx.invlists), 4, device="cpu")
    jfn = jcand.index_candidate_fn_batched(jidx, jnp.array(cat), 32, 16, h=h)
    tfn = tcand.index_candidate_fn_batched(tidx, _t(cat), 32, 16, h=h)
    wi, wd, wv = (np.asarray(a) for a in jfn(jnp.array(reqs[:b]), jnp.array(x)))
    gi, gd, gv = (a.numpy() for a in tfn(_t(reqs[:b]), _t(x)))
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=1e-5 * 10)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gi, wi)


def test_registry_and_specs():
    assert set(tbase.registered_backends()) == {"flat", "ivf", "ivfpq", "lsh", "nsw",
                                                "ivf_sharded"}
    assert tbase.registered_backends(sharded=True) == ("ivf_sharded",)
    assert tbase.registered_backends(sharded=False) == ("flat", "ivf", "ivfpq", "lsh", "nsw")
    with pytest.raises(ValueError, match=r"unknown index backend 'nope'; "
                                         r"registered: flat, ivf, ivf_sharded, ivfpq, lsh, "
                                         r"nsw"):
        tbase.resolve_spec("nope")
    assert tbase.resolve_spec("exact") is None
    assert tbase.resolve_spec({"backend": "exact"}) is None
    spec = tbase.resolve_spec({"backend": "ivf", "nlist": 4, "nprobe": 2})
    assert spec == tbase.IndexSpec("ivf", {"nlist": 4, "nprobe": 2})
    assert tbase.IndexSpec.from_dict(spec.to_dict()) == spec
    idx = tbase.build_index(spec, np.random.default_rng(0).random((50, 4), np.float32),
                            device="cpu")
    assert isinstance(idx, tbase.Index) and idx.n == 50 and idx.exact_distances
    with pytest.raises(ValueError, match="NaN/Inf"):
        idx.query(torch.tensor([[0.0, float("nan"), 0.0, 0.0]]), 3)
