"""Port parity, the LSH and NSW backends and the registry: repro_torch's
`LSHIndex` and `NSWIndex` against repro's, on the CPU.

Structures built in numpy (LSH hyperplanes and buckets, the NSW graph)
must be bitwise the reference's; the NSW entry points come from k-means
started at the reference's `jax.random` rows.  Queries: distances to
rtol 1e-5, atol 1e-5 x the distance scale (another summation order), ids
and the -1 underflow slots equal wherever the reference's margin exceeds
that tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import trace as jtrace
from repro.index import candidates as jcand
from repro.index.lsh import LSHIndex as JLSH
from repro.index.nsw import NSWIndex as JNSW
from repro_torch import convert
from repro_torch.index import base as tbase
from repro_torch.index import candidates as tcand
from repro_torch.index.lsh import LSHIndex
from repro_torch.index.nsw import NSWIndex

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


def _entry_rows(seed: int, n: int, k: int) -> np.ndarray:
    """The reference's initial k-means rows for the NSW entry points."""
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, shape=(k,),
                                        replace=False))


@pytest.fixture(scope="module")
def clustered():
    cat, reqs, _ = jtrace.amazon_like(n=1200, d=16, t=64, clusters=12, seed=3)
    return cat, reqs


@pytest.fixture(scope="module")
def sift400():
    """tests/test_index_api.py's catalog for the underflow cases."""
    cat, reqs, _ = jtrace.sift_like(n=400, d=16, t=64, seed=0)
    return cat, reqs


@pytest.mark.parametrize("tables,bits,cap,seed", [(4, 5, None, 0), (12, 8, None, 1),
                                                  (2, 6, 4, 2)])
def test_lsh_planes_and_buckets_are_the_references(clustered, tables, bits, cap, seed):
    cat = clustered[0]
    ref = JLSH(jnp.array(cat), tables=tables, bits=bits, cap=cap, seed=seed)
    port = LSHIndex(cat, tables=tables, bits=bits, cap=cap, seed=seed, device="cpu")
    np.testing.assert_array_equal(port.planes.numpy(), ref.planes)
    np.testing.assert_array_equal(port.buckets.numpy(), np.asarray(ref.buckets))
    assert port.memory_bytes() == int(port.embeddings.nbytes + port.buckets.nbytes
                                      + port.planes.nbytes + port.valid.nbytes)


@pytest.mark.parametrize("degree,beam,steps,seed", [(8, 16, 8, 0), (16, 48, 16, 1)])
def test_nsw_graph_and_entry_points_are_the_references(clustered, degree, beam, steps,
                                                       seed):
    cat = clustered[0]
    ref = JNSW(jnp.array(cat), degree=degree, beam=beam, steps=steps, seed=seed)
    port = NSWIndex(cat, degree=degree, beam=beam, steps=steps, seed=seed,
                    init_idx=_entry_rows(seed, cat.shape[0], beam), device="cpu")
    np.testing.assert_array_equal(port.graph.numpy(), np.asarray(ref.graph))
    np.testing.assert_array_equal(port.entry_points.numpy(),
                                  np.asarray(ref.entry_points))


@pytest.mark.parametrize("how", ["built", "loaded"])
def test_lsh_query_matches_reference(clustered, how):
    cat, reqs = clustered
    ref = JLSH(jnp.array(cat), tables=12, bits=8)
    port = (LSHIndex(cat, tables=12, bits=8, device="cpu") if how == "built" else
            convert.lsh_from_numpy(cat, ref.planes, ref.buckets, device="cpu"))
    for b in (1, 8):
        for k in (10, 64):
            wd, wi = ref.query(jnp.array(reqs[:b]), k)
            gd, gi = port.query(_t(reqs[:b]), k)
            assert gi.dtype == torch.int32
            _check_topk(gd, gi, wd, wi, scale=10.0)


@pytest.mark.parametrize("how", ["built", "loaded"])
def test_nsw_query_matches_reference(clustered, how):
    cat, reqs = clustered
    ref = JNSW(jnp.array(cat), degree=16, beam=48, steps=16)
    if how == "built":
        port = NSWIndex(cat, degree=16, beam=48, steps=16,
                        init_idx=_entry_rows(0, cat.shape[0], 48), device="cpu")
    else:
        port = convert.nsw_from_numpy(cat, ref.graph, ref.entry_points, beam=48,
                                      steps=16, expand=2, device="cpu")
    for b in (1, 8):
        for k in (10, 32):
            wd, wi = ref.query(jnp.array(reqs[:b]), k)
            gd, gi = port.query(_t(reqs[:b]), k)
            assert gi.dtype == torch.int32
            _check_topk(gd, gi, wd, wi, scale=10.0)


def test_underflow_matches_reference(sift400):
    """tests/test_index_api.py's underflow cases: a capped LSH reaches fewer
    than k distinct candidates, and k beyond the NSW beam pads with -1."""
    cat, reqs = sift400
    ref = JLSH(jnp.array(cat), tables=2, bits=6, cap=4)
    port = LSHIndex(cat, tables=2, bits=6, cap=4, device="cpu")
    for b, k in ((16, 8), (4, 16)):
        wd, wi = ref.query(jnp.array(reqs[:b]), k)
        gd, gi = port.query(_t(reqs[:b]), k)
        assert (gi.numpy() == -1).any()
        _check_topk(gd, gi, wd, wi, scale=10.0)
    ref = JNSW(jnp.array(cat), degree=8, beam=16, steps=8)
    port = NSWIndex(cat, degree=8, beam=16, steps=8,
                    init_idx=_entry_rows(0, cat.shape[0], 16), device="cpu")
    wd, wi = ref.query(jnp.array(reqs[:4]), 20)
    gd, gi = port.query(_t(reqs[:4]), 20)
    assert gd.shape == (4, 20) and (gi[:, 16:] == -1).all()
    assert torch.isinf(gd[:, 16:]).all()
    _check_topk(gd, gi, wd, wi, scale=10.0)


@pytest.mark.parametrize("backend", ["lsh", "nsw"])
def test_candidate_slabs_match_reference(clustered, backend):
    cat, reqs = clustered
    n, h = cat.shape[0], 48
    x = (np.random.default_rng(1).random(n) < h / n).astype(np.float32)
    if backend == "lsh":
        ref = JLSH(jnp.array(cat), tables=12, bits=8)
        port = convert.lsh_from_numpy(cat, ref.planes, ref.buckets, device="cpu")
    else:
        ref = JNSW(jnp.array(cat), degree=16, beam=48, steps=16)
        port = convert.nsw_from_numpy(cat, ref.graph, ref.entry_points, beam=48,
                                      steps=16, expand=2, device="cpu")
    jfn = jcand.index_candidate_fn_batched(ref, jnp.array(cat), 32, 16, h=h)
    tfn = tcand.index_candidate_fn_batched(port, _t(cat), 32, 16, h=h)
    wi, wd, wv = (np.asarray(a) for a in jfn(jnp.array(reqs[:8]), jnp.array(x)))
    gi, gd, gv = (a.numpy() for a in tfn(_t(reqs[:8]), _t(x)))
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=1e-5 * 10)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gi, wi)


def test_every_single_device_backend_is_registered():
    assert set(tbase.registered_backends()) == {"flat", "ivf", "ivfpq", "lsh", "nsw",
                                                "ivf_sharded"}
    assert set(tbase.registered_backends(sharded=False)) == {"flat", "ivf", "ivfpq", "lsh",
                                                             "nsw"}
    cat = np.random.default_rng(0).random((200, 8), np.float32)
    for name, kw in {"ivfpq": {"nlist": 4, "nprobe": 2, "m": 2},
                     "lsh": {"tables": 2, "bits": 4},
                     "nsw": {"degree": 6, "beam": 8, "steps": 4}}.items():
        idx = tbase.build_index(tbase.IndexSpec(name, kw), cat, device="cpu")
        assert isinstance(idx, tbase.Index) and idx.n == 200
        d, ids = idx.query(torch.from_numpy(cat[:3]), 5)
        assert d.shape == ids.shape == (3, 5) and ids.dtype == torch.int32
        with pytest.raises(ValueError, match="NaN/Inf"):
            idx.query(torch.full((1, 8), float("nan")), 3)
