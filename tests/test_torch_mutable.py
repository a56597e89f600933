"""Port parity, the mutable catalog: repro_torch's capacity slabs, the five
backends' add / remove / refresh (blocking and two-phase) / compact and
AcaiCache's mutable serving against repro's, on the CPU.

Both packages get the same numpy inputs.  The trained structures' initial
rows are the reference's `jax.random` draws, handed to the port through
`init_fn` / `pq_init_fn`, and the rounding uniforms are the reference's
`k_round` draws at each step, over the state's current length (the slab's
capacity).  Tolerances (ROADMAP's rule): ids, capacities, n_slots, remaps,
served flags and x exact; distances and y to 1e-5; an id may differ only
where the reference's distances are within that tolerance of a neighbour.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import oma as joma
from repro.core import policy as jpol
from repro.core import trace as jtrace
from repro.index import IndexSpec as JSpec
from repro.index import build_index as jbuild
from repro.index.base import TINY_BUILD_KWARGS as TINY
from repro.index.base import slab_append as jslab_append
from repro_torch import convert
from repro_torch.core import oma as toma
from repro_torch.core import policy as tpol
from repro_torch.index import base as tbase
from repro_torch.index.base import IndexSpec, build_index
from repro_torch.kernels import ops

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def jinit(seed: int):
    """init_fn(n, k): the reference's k-means rows, choice(PRNGKey(seed))."""
    def fn(n, k):
        return np.array(jax.random.choice(jax.random.PRNGKey(seed), n, shape=(k,),
                                          replace=False))
    return fn


def jpq_init(seed: int, m: int):
    """pq_init_fn(n, ksub): the reference's codebook rows, one choice under
    each key of split(PRNGKey(seed), m)."""
    def fn(n, k):
        return np.stack([np.array(jax.random.choice(key, n, shape=(k,), replace=False))
                         for key in jax.random.split(jax.random.PRNGKey(seed), m)])
    return fn


def port_params(backend: str) -> dict:
    """TINY's params with the reference's initial rows for every build."""
    p = dict(TINY[backend])
    if backend in ("ivf", "ivfpq", "nsw"):
        p["init_fn"] = jinit(0)
    if backend == "ivfpq":
        p["pq_init_fn"] = jpq_init(1, p["m"])
    return p


def pair(backend: str, cat):
    ref = jbuild(JSpec(backend, TINY[backend]), jnp.asarray(cat))
    port = build_index(IndexSpec(backend, port_params(backend)), np.asarray(cat),
                       device="cpu")
    return ref, port


def check_topk(got, want, scale=1.0):
    gd, gi = (np.asarray(a) for a in got)
    wd, wi = (np.asarray(a) for a in want)
    tol = 1e-5 * scale
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=tol)
    np.testing.assert_array_equal(gi == -1, wi == -1)
    finite = np.where(np.isfinite(wd), wd, 1e30)
    gap = np.diff(finite, axis=1)
    inf = np.full((wd.shape[0], 1), np.inf)
    margin = np.minimum(np.concatenate([inf, gap], 1), np.concatenate([gap, inf], 1))
    decided = margin > tol + RTOL * np.abs(finite)
    np.testing.assert_array_equal(gi[decided], wi[decided])


def query_both(ref, port, q, k):
    got = port.query(_t(q), k)
    want = ref.query(jnp.asarray(q), k)
    check_topk(got, want)
    return np.asarray(want[1])


def check_structures(ref, port):
    """Slab and structures equal the reference's (the trained ones to the
    same lists; codes, buckets and graphs exactly)."""
    assert (port.n, port.capacity, port.n_slots) == (ref.n, ref.capacity, ref.n_slots)
    np.testing.assert_array_equal(port.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(port.embeddings.numpy(), np.asarray(ref.embeddings))
    if hasattr(ref, "invlists"):
        np.testing.assert_array_equal(port.invlists.numpy(), np.asarray(ref.invlists))
        np.testing.assert_array_equal(port.lens.numpy(),
                                      ops.invlist_lengths(port.invlists).numpy())
        np.testing.assert_allclose(port.centroids.numpy(), np.asarray(ref.centroids),
                                   rtol=RTOL, atol=1e-5)
    if hasattr(ref, "codes"):
        check_codes(ref, port)
        np.testing.assert_array_equal(
            port.codes_lists.numpy(), ops.codes_by_list(port.codes, port.invlists).numpy())
    if hasattr(ref, "buckets"):
        np.testing.assert_array_equal(port.buckets.numpy(), np.asarray(ref.buckets))
    if hasattr(ref, "graph"):
        np.testing.assert_array_equal(port.graph.numpy(), np.asarray(ref.graph))
        np.testing.assert_array_equal(port.entry_points.numpy(),
                                      np.asarray(ref.entry_points))


def check_codes(ref, port):
    """Codebooks to 1e-5 and the assigned rows' codes equal, but where a
    row's subvector is within float32 reach of both codewords (the two
    frameworks sum the subspace distances in other orders, so a near-tie
    may go either way).  Rows past n_slots are unused: the reference's
    padded write leaves codes of zero rows there, the port zeros."""
    books = port.codec.codebooks.numpy()
    np.testing.assert_allclose(books, np.asarray(ref.codec.codebooks), rtol=RTOL, atol=1e-5)
    n = port.n_slots
    got, want = port.codes.numpy()[:n].astype(np.int64), np.asarray(ref.codes)[:n]
    emb, dsub = port.embeddings.numpy(), books.shape[2]
    for row, m in zip(*np.nonzero(got != want)):
        sub = emb[row, m * dsub:(m + 1) * dsub]
        d = [float(((sub - books[m, c]) ** 2).sum()) for c in (got[row, m], want[row, m])]
        assert abs(d[0] - d[1]) <= 1e-5 * (1 + d[1]), (row, m, d)


@pytest.fixture(scope="module")
def setup():
    catalog, reqs, _ = jtrace.sift_like(n=300, d=16, t=48, seed=0)
    rng = np.random.default_rng(7)
    newv = (rng.random((60, 16)) * 0.9 + 0.05).astype(np.float32)
    return catalog, reqs, newv


# ---------------------------------------------------------------------------
# slabs: the growth schedule and ids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n0,cap,batches", [
    (300, 300, (20, 20, 20)),
    # at 481 of 512 rows a batch of 10 fits, but the reference's padded
    # write of 32 does not: the slab doubles there, and must here too
    (481, 512, (10, 1, 30)),
    (100, 128, (64, 65, 1))])
def test_slab_growth_matches_reference(n0, cap, batches):
    rng = np.random.default_rng(n0)
    emb0 = np.zeros((cap, 8), np.float32)
    emb0[:n0] = rng.random((n0, 8), dtype=np.float32)
    valid0 = np.arange(cap) < n0
    jemb, jvalid, tvemb, tvalid = jnp.asarray(emb0), jnp.asarray(valid0), _t(emb0), _t(valid0)
    jn = tn = n0
    for b in batches:
        vec = rng.random((b, 8), dtype=np.float32)
        jemb, jvalid, jids = jslab_append(jemb, jvalid, jn, vec)
        tvemb, tvalid, tids = tbase.slab_append(tvemb, tvalid, tn, _t(vec))
        jn, tn = jn + b, tn + b
        np.testing.assert_array_equal(tids, jids)
        assert tids.dtype == np.int32
        assert tvemb.shape == jemb.shape and tvalid.shape == jvalid.shape
        np.testing.assert_array_equal(tvemb.numpy(), np.asarray(jemb))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    for b in (1, 31, 32, 33, 1000):
        assert tbase.bucket_width(b) == max(32, 1 << (b - 1).bit_length())


# ---------------------------------------------------------------------------
# all-backends conformance against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", sorted(TINY))
def test_add_remove_refresh_conformance(setup, backend):
    cat, rq, newv = setup
    ref, port = pair(backend, cat)
    check_structures(ref, port)
    ids = port.add(newv)
    np.testing.assert_array_equal(ids, ref.add(newv))
    np.testing.assert_array_equal(ids, np.arange(300, 360))
    check_structures(ref, port)
    got = query_both(ref, port, newv[:16], 5)
    assert sum(int(ids[j]) in set(got[j]) for j in range(16)) >= 14
    top = query_both(ref, port, rq[:16], 5)
    doomed = np.unique(top[:, 0])
    port.remove(doomed)
    ref.remove(doomed)
    check_structures(ref, port)
    after = query_both(ref, port, rq[:16], 8)
    assert not set(doomed.tolist()) & set(after.ravel().tolist())
    port.refresh()
    ref.refresh()
    check_structures(ref, port)
    again = query_both(ref, port, rq[:16], 8)
    assert not set(doomed.tolist()) & set(again.ravel().tolist())
    # the loud errors, with the reference's messages
    with pytest.raises(ValueError, match="already dead"):
        port.remove(doomed[:1])
    with pytest.raises(ValueError, match="assigned rows"):
        port.remove(np.asarray([port.n_slots + 5]))
    with pytest.raises(ValueError, match="duplicate"):
        port.remove(np.asarray([ids[0], ids[0]]))
    assert port.n == ref.n


@pytest.mark.parametrize("backend", sorted(TINY))
def test_refresh_matches_fresh_build(setup, backend):
    """After a refresh the index answers like a fresh build over the live
    rows (modulo the id remap), as the reference's does."""
    cat, rq, newv = setup
    ref, port = pair(backend, cat)
    doomed = np.random.default_rng(11).choice(360, size=80, replace=False)
    for idx in (ref, port):
        idx.add(newv)
        idx.remove(doomed)
        idx.refresh()
    check_structures(ref, port)
    live = port.live_rows()
    np.testing.assert_array_equal(live, np.asarray(ref.live_rows()))
    fresh = build_index(IndexSpec(backend, port_params(backend)),
                        port.embeddings.numpy()[live], device="cpu")
    d_a, i_a = port.query(_t(rq[:16]), 5)
    d_b, i_b = fresh.query(_t(rq[:16]), 5)
    np.testing.assert_allclose(d_a.numpy(), d_b.numpy(), atol=1e-4)
    i_b = i_b.numpy()
    np.testing.assert_array_equal(i_a.numpy(), np.where(i_b >= 0, live[np.clip(i_b, 0, None)],
                                                        -1))
    query_both(ref, port, rq[:16], 5)


@pytest.mark.parametrize("backend", sorted(TINY))
def test_two_phase_refresh_stale_then_fresh(setup, backend):
    cat, rq, newv = setup
    ref, port = pair(backend, cat)
    twin = build_index(IndexSpec(backend, port_params(backend)), cat, device="cpu")
    doomed = np.random.default_rng(5).choice(300, size=40, replace=False)
    for idx in (ref, port, twin):
        idx.add(newv)
        idx.remove(doomed)
    assert not port.refresh_pending
    port.refresh_start()
    ref.refresh_start()
    # a structure-free backend has nothing to shadow
    assert port.refresh_pending == ref.refresh_pending == (backend != "flat")
    # between start and swap the stale structures serve, bitwise
    for a, b in zip(port.query(_t(rq[:16]), 5), twin.query(_t(rq[:16]), 5)):
        assert torch.equal(a, b)
    port.refresh_swap()
    ref.refresh_swap()
    assert not port.refresh_pending
    twin.refresh()  # blocking: both phases back to back
    for a, b in zip(port.query(_t(rq[:16]), 5), twin.query(_t(rq[:16]), 5)):
        assert torch.equal(a, b)
    check_structures(ref, port)
    query_both(ref, port, rq[:16], 5)


def test_shadow_discarded_on_interleaved_mutation(setup):
    cat, rq, newv = setup
    ref, port = pair("ivf", cat)
    twin = build_index(IndexSpec("ivf", port_params("ivf")), cat, device="cpu")
    port.refresh_start()
    ref.refresh_start()
    assert port.refresh_pending
    for idx in (port, twin, ref):
        idx.add(newv[:8])
    assert not port.refresh_pending
    port.refresh_swap()  # a no-op: the shadow was discarded
    ref.refresh_swap()
    for a, b in zip(port.query(_t(rq[:8]), 5), twin.query(_t(rq[:8]), 5)):
        assert torch.equal(a, b)
    check_structures(ref, port)


@pytest.mark.parametrize("backend", sorted(TINY))
def test_compact_matches_reference(setup, backend):
    """Compaction: the remap, the slab and the rebuilt structures equal the
    reference's; the id space restarts dense."""
    cat, rq, newv = setup
    ref, port = pair(backend, cat)
    doomed = np.random.default_rng(13).choice(360, size=100, replace=False)
    for idx in (ref, port):
        idx.add(newv)
        idx.remove(doomed)
    live = port.live_rows()
    old_cap = port.capacity
    remap = port.compact()
    np.testing.assert_array_equal(remap, np.asarray(ref.compact()))
    assert remap.shape == (old_cap,) and remap.dtype == np.int32
    np.testing.assert_array_equal(remap[live], np.arange(len(live)))
    assert port.n == port.n_slots == len(live)
    assert port.answer_stable_compact == ref.answer_stable_compact == (backend == "flat")
    check_structures(ref, port)
    query_both(ref, port, rq[:16], 5)
    ids = port.add(newv[:4])
    np.testing.assert_array_equal(ids, ref.add(newv[:4]))
    np.testing.assert_array_equal(ids, np.arange(len(live), len(live) + 4))
    check_structures(ref, port)
    query_both(ref, port, newv[:4], 3)


@pytest.mark.parametrize("backend", sorted(TINY))
def test_mutated_index_loads_from_reference(setup, backend):
    """convert's loaders take a reference-built, mutated index (slab at its
    capacity, valid, n_slots, the structures): the loaded index answers and
    mutates on as the reference does."""
    cat, rq, newv = setup
    ref = jbuild(JSpec(backend, TINY[backend]), jnp.asarray(cat))
    ref.add(newv[:40])
    ref.remove(np.arange(0, 300, 7))
    slab, valid, n_slots = np.asarray(ref.embeddings), np.asarray(ref.valid), ref.n_slots
    if backend == "flat":
        port = convert.flat_from_numpy(slab, valid, n_slots, device="cpu")
    elif backend == "ivf":
        port = convert.ivf_from_numpy(slab, ref.centroids, ref.invlists, ref.nprobe, valid,
                                      n_slots, init_fn=jinit(0), device="cpu")
    elif backend == "ivfpq":
        port = convert.ivfpq_from_numpy(slab, ref.centroids, ref.invlists,
                                        ref.codec.codebooks, ref.codes, ref.nprobe,
                                        ref.refine, valid, n_slots, init_fn=jinit(0),
                                        pq_init_fn=jpq_init(1, ref.m), device="cpu")
    elif backend == "lsh":
        port = convert.lsh_from_numpy(slab, ref.planes, ref.buckets, valid, n_slots,
                                      device="cpu")
    else:
        port = convert.nsw_from_numpy(slab, ref.graph, ref.entry_points, ref.beam, ref.steps,
                                      ref.expand, valid, n_slots, init_fn=jinit(0),
                                      device="cpu")
    check_structures(ref, port)
    query_both(ref, port, rq[:16], 5)
    if backend != "nsw":  # a loaded NSW's insertion generator starts afresh
        np.testing.assert_array_equal(port.add(newv[40:]), ref.add(newv[40:]))
    port.remove(np.arange(1, 300, 7))
    ref.remove(np.arange(1, 300, 7))
    port.refresh()
    ref.refresh()
    check_structures(ref, port)
    query_both(ref, port, rq[:16], 8)


def test_no_reallocation_at_fixed_capacity(setup):
    """At a fixed capacity no mutation allocates: the slab, the mask, the
    list table, the lists' lengths, the code slabs, the buckets and the
    graph keep their storage (the reference's no-retrace guard)."""
    cat, rq, newv = setup
    names = ("embeddings", "valid", "invlists", "lens", "codes", "codes_lists",
             "buckets", "graph")
    for backend in sorted(TINY):
        idx = build_index(IndexSpec(backend, port_params(backend)), cat, device="cpu")
        idx.add(newv[:40])   # grows the slab (and doubles full lists)
        idx.remove(np.arange(0, 40))
        ptrs = {n: getattr(idx, n).data_ptr() for n in names if hasattr(idx, n)}
        cap = idx.capacity
        for j in range(40, 46):
            idx.add(newv[j:j + 1])
            idx.remove(np.asarray([j]))
            idx.query(_t(rq[:4]), 5)
        assert idx.capacity == cap
        grown = [n for n, p in ptrs.items() if getattr(idx, n).data_ptr() != p]
        assert not grown, f"{backend}: {grown} reallocated at capacity {cap}"


# ---------------------------------------------------------------------------
# AcaiCache: the mutable serving step
# ---------------------------------------------------------------------------

def _cfgs(rounding="depround", **oma_kw):
    kw = dict(h=24, k=4, c_f=1.0, c_remote=16, c_local=8)
    return (jpol.AcaiConfig(**kw, oma=joma.OMAConfig(eta=0.05, rounding=rounding, **oma_kw)),
            tpol.AcaiConfig(**kw, oma=toma.OMAConfig(eta=0.05, rounding=rounding, **oma_kw)))


class RefUniforms:
    """The reference AcaiCache's rounding uniforms at step i over n rows:
    k_round of the i-th split of its state key, uniform((n,)), or
    ((n - 1,)) for DepRound (the port's DepRound reads the first n - 1)."""

    def __init__(self, key, rounding: str):
        self.key, self.rounding, self.rounds = key, rounding, []

    def __call__(self, i: int, n: int):
        while len(self.rounds) <= i:
            self.key, k_round = jax.random.split(self.key)
            self.rounds.append(k_round)
        m = n - 1 if self.rounding == "depround" else n
        u = np.asarray(jax.random.uniform(self.rounds[i], (m,), dtype=jnp.float32))
        return torch.from_numpy(np.concatenate([u, np.zeros(n - m, np.float32)]))


def caches(cat, jcfg, tcfg, index=None, port_index=None):
    jc = jpol.AcaiCache(jnp.asarray(cat), dataclasses.replace(jcfg, index=index), seed=0)
    tc = tpol.AcaiCache(cat, dataclasses.replace(tcfg, index=port_index), seed=0,
                        device="cpu")
    tc.state = convert.cache_state_from_numpy(jc.state.y, jc.state.x, 0, device="cpu")
    return jc, tc, RefUniforms(jc.state.key, jcfg.oma.rounding)


def check_state(jc, tc, jm=None, tm=None):
    np.testing.assert_allclose(tc.state.y.numpy(), np.asarray(jc.state.y), rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_array_equal(tc.state.x.numpy(), np.asarray(jc.state.x))
    assert tc.live_count == jc.live_count
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    assert tc.catalog.shape == jc.catalog.shape
    if jm is not None:
        np.testing.assert_allclose(tm.gain_int.numpy(), np.asarray(jm.gain_int), rtol=RTOL,
                                   atol=1e-5)
        np.testing.assert_array_equal(tm.served_local.numpy(), np.asarray(jm.served_local))
        np.testing.assert_array_equal(tm.fetched.numpy(), np.asarray(jm.fetched))


@pytest.mark.parametrize("index", [None, "ivf"])
def test_acai_cache_invalidation_invariant(setup, index):
    """Add, remove and serve, step by step against the reference with its
    uniforms: y, x, gains and served flags agree, and y = x = 0 on every
    removed row through every update."""
    cat, rq, newv = setup
    jcfg, tcfg = _cfgs()
    jc, tc, us = caches(cat, jcfg, tcfg, None if index is None else JSpec("ivf", TINY["ivf"]),
                        None if index is None else IndexSpec("ivf", port_params("ivf")))
    step = 0
    for s in range(0, 16, 8):
        jm = jc.serve_update_batch(jnp.asarray(rq[s:s + 8]))
        tm = tc.serve_update_batch(_t(rq[s:s + 8]), us(step, tc.state.y.shape[0]))
        step += 1
        check_state(jc, tc, jm, tm)
    ids = tc.add_objects(newv[:30])
    np.testing.assert_array_equal(ids, jc.add_objects(jnp.asarray(newv[:30])))
    check_state(jc, tc)
    assert tc.state.y.shape[0] == tc.catalog.shape[0] >= 330
    assert float(tc.state.y[301]) > 0  # the uniform prior
    doomed = tc.cached_ids.numpy()[:6]
    tc.remove_objects(doomed)
    jc.remove_objects(doomed)
    check_state(jc, tc)
    for s in range(16, 48, 8):
        jm = jc.serve_update_batch(jnp.asarray(rq[s:s + 8]))
        tm = tc.serve_update_batch(_t(rq[s:s + 8]), us(step, tc.state.y.shape[0]))
        step += 1
        check_state(jc, tc, jm, tm)
        assert float(tc.state.y[doomed].abs().sum()) == 0.0
        assert float(tc.state.x[doomed].abs().sum()) == 0.0
    assert float(tm.occupancy[0]) <= tcfg.h + 1e-6
    assert tc.live_count == 330 - 6
    m1 = tc.serve_update(_t(rq[0]))
    assert m1.gain_int.dim() == 0
    # compaction: y and x move with their rows
    y, x, live = tc.state.y.clone(), tc.state.x.clone(), np.nonzero(tc.valid.numpy())[0]
    remap = tc.compact()
    np.testing.assert_array_equal(remap[live], np.arange(len(live)))
    np.testing.assert_array_equal(tc.state.y[:len(live)].numpy(), y[live].numpy())
    np.testing.assert_array_equal(tc.state.x[:len(live)].numpy(), x[live].numpy())
    assert float(tc.state.y[len(live):].abs().sum()) == 0.0
    assert tc.catalog.shape[0] == tc.state.y.shape[0] == tbase.grow_capacity(
        0, len(live) + tbase.MIN_WRITE, 1)


def test_mutable_path_matches_static_when_all_alive(setup):
    """The mutable step with every row alive advances the state as the
    static step does (same candidates, same uniforms)."""
    cat, rq, _ = setup
    _, tcfg = _cfgs("coupled")
    a = tpol.AcaiCache(cat, tcfg, seed=0, device="cpu")
    b = tpol.AcaiCache(cat, tcfg, seed=0, device="cpu")
    b.state = tpol.copy_state(a.state)
    b._enter_mutable()
    g = torch.Generator().manual_seed(3)
    for s in range(0, 48, 8):
        u = torch.rand(cat.shape[0], generator=g)
        ma = a.serve_update_batch(_t(rq[s:s + 8]), u)
        mb = b.serve_update_batch(_t(rq[s:s + 8]), u)
        np.testing.assert_allclose(ma.gain_int.numpy(), mb.gain_int.numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(ma.served_local.numpy(), mb.served_local.numpy())
    np.testing.assert_allclose(a.state.y.numpy(), b.state.y.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(a.state.x.numpy(), b.state.x.numpy())


def test_acai_cache_mutation_guards(setup):
    cat, _, newv = setup
    _, tcfg = _cfgs()
    fn = tpol.exact_candidate_fn_batched(_t(cat), 16, 8)
    custom = tpol.AcaiCache(cat, tcfg, candidate_fn_batched=fn, seed=0, device="cpu")
    with pytest.raises(ValueError, match="explicit candidate_fn"):
        custom.add_objects(newv[:2])
    assert not custom._mutated
    clean = tpol.AcaiCache(cat, tcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        clean.remove_objects([5, 5])
    with pytest.raises(ValueError):
        clean.remove_objects([cat.shape[0] + 7])
    assert not clean._mutated and clean.live_count == cat.shape[0]
    clean.remove_objects([5])
    with pytest.raises(ValueError, match="already dead"):
        clean.remove_objects([5])
    assert clean.live_count == cat.shape[0] - 1
    # the answer tier is single-device (the sharded step owns candidate
    # generation), as in the reference; it rejects what is not a spec form
    with pytest.raises(NotImplementedError, match="answer_cache= on a sharded mesh"):
        tpol.AcaiCache(cat, tcfg, device="cpu", mesh=object(), answer_cache=8)
    with pytest.raises(TypeError, match="answer_cache"):
        tpol.AcaiCache(cat, tcfg, device="cpu", answer_cache=object())


@pytest.mark.parametrize("b,c", [(1, 12), (8, 24), (64, 80)])
def test_deterministic_scatter_is_the_references_add(b, c):
    """scatter_rows_sum against the reference's `.at[ids].add` over the
    valid slots (each row naming an id at most once, as a deduplicated
    candidate slab does), and bitwise the same on a repeat."""
    rng = np.random.default_rng(b)
    n = 2 * c
    ids = np.stack([rng.permutation(n + 5)[:c] for _ in range(b)])
    valid = (ids < n) & (rng.random((b, c)) < 0.8)
    vals = rng.normal(size=(b, c)).astype(np.float32)
    ids_c = np.minimum(ids, n - 1)
    want = np.asarray(jnp.zeros(n).at[ids_c.reshape(-1)].add(
        jnp.where(valid, vals, 0.0).reshape(-1)))
    got = tpol.scatter_rows_sum(n, _t(ids_c), _t(vals), _t(valid))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, tpol.scatter_rows_sum(n, _t(ids_c), _t(vals), _t(valid)))


@pytest.mark.parametrize("live_in_sample", [0, 10, 2000])
def test_topk_bound_holds_over_live_rows_only(live_in_sample):
    """`topk_l2`'s sampled bound under tombstones: a rolling window kills
    the oldest rows first, which are the sample's.  With fewer than k live
    sample rows the bound is +inf (the kernel runs unpruned); otherwise it
    is at least every query's k-th live distance over the whole catalog."""
    n, d, k = ops.TOPK_SAMPLE_MIN_N, 8, 64
    g = torch.Generator().manual_seed(live_in_sample)
    x = torch.rand(n, d, generator=g)
    q = torch.rand(5, d, generator=g)
    valid = torch.rand(n, generator=g) < 0.5
    valid[:ops.TOPK_SAMPLE] = False
    valid[torch.randperm(ops.TOPK_SAMPLE, generator=g)[:live_in_sample]] = True
    bound = ops.topk_l2_bound(q, torch.sum(q * q, 1), x, k, valid)
    if live_in_sample < k:
        assert torch.isinf(bound).all()
    else:
        kth = ops.topk_l2(q, x, k, valid=valid)[0][:, -1]
        assert torch.isfinite(bound).all() and (bound >= kth).all()
