"""Port parity, the answer-cache tier: repro_torch.serve.answer_cache
against repro.serve.answer_cache, on the CPU.

Both packages get the same numpy inputs.  Held exactly: the spec forms,
the store's hit masks, LRU evictions, invalidation counts by reason and
stats after the same store / lookup / add / remove / compact / refresh
sequence, for every backend (the trained structures' initial rows are the
reference's `jax.random` draws, as tests/test_torch_mutable.py hands
them over).  The memoized answers: ids exact, distances to 1e-5.  The
port's own pin, cache-on against pass-through (capacity 0), is bitwise on
the CPU, as the reference's own is; the port against the reference is
compared with tolerances only (ROADMAP C: the reference's bitwise pins
drift by an ulp).  AÇAI replays against the reference's take its rounding
uniforms (`k_round` of each step); gains to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy_api as JPA
from repro.core import trace as jtrace
from repro.core.costs import CostModel as JCostModel
from repro.index import IndexSpec as JSpec
from repro.index import build_index as jbuild
from repro.index.base import TINY_BUILD_KWARGS as TINY
from repro.serve import answer_cache as JAC
from repro_torch import convert
from repro_torch.core import policy_api as PA
from repro_torch.core.costs import CostModel
from repro_torch.index.base import IndexSpec, build_index
from repro_torch.serve import answer_cache as AC
from repro_torch.serve.answer_cache import (AnswerCache, AnswerCacheSpec, CachedIndex,
                                            parse_answer_cache_opts,
                                            resolve_answer_cache_spec)

K = 4
RTOL = 1e-5


def jinit(seed: int):
    def fn(n, k):
        return np.array(jax.random.choice(jax.random.PRNGKey(seed), n, shape=(k,),
                                          replace=False))
    return fn


def jpq_init(seed: int, m: int):
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


def reference_uniforms(key, n: int, steps: int) -> np.ndarray:
    out = np.empty((steps, n), np.float32)
    for i in range(steps):
        key, k_round = jax.random.split(key)
        out[i] = np.asarray(jax.random.uniform(k_round, (n,), dtype=jnp.float32))
    return out


@pytest.fixture(scope="module")
def setup():
    catalog, reqs, _ = jtrace.sift_like(n=240, d=12, t=64, zipf_a=1.1, jitter=0.0,
                                        seed=3)
    rng = np.random.default_rng(5)
    newv = (rng.random((24, 12)) * 0.9 + 0.05).astype(np.float32)
    return np.asarray(catalog), np.asarray(reqs), newv


def _policy(catalog, index_spec, cap, *, batch=8, seed=0, **spec_kw):
    return PA.build_policy(PA.PolicySpec("acai", {"h": 32, "k": K, "batch": batch}),
                           catalog, CostModel(c_f=0.3), index_spec=index_spec, seed=seed,
                           answer_cache=AnswerCacheSpec(capacity=cap, **spec_kw),
                           device="cpu")


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# spec plumbing: the reference's forms and errors
# ---------------------------------------------------------------------------

def test_spec_roundtrip_and_validation():
    spec = AnswerCacheSpec(capacity=128, hit_ms=0.5, idle_unload_ms=40.0)
    assert AnswerCacheSpec.from_dict(spec.to_dict()) == spec
    assert spec.to_dict() == JAC.AnswerCacheSpec(128, 0.5, 40.0).to_dict()
    assert spec.with_params(capacity=0).capacity == 0
    for kw, msg in (({"capacity": -1}, "capacity"), ({"hit_ms": -0.1}, "hit_ms"),
                    ({"idle_unload_ms": 0}, "idle_unload_ms")):
        with pytest.raises(ValueError, match=msg):
            AnswerCacheSpec(**kw)
        with pytest.raises(ValueError, match=msg):
            JAC.AnswerCacheSpec(**kw)
    with pytest.raises(ValueError, match="unknown fields"):
        AnswerCacheSpec.from_dict({"capcity": 7})


@pytest.mark.parametrize("value", [None, False, True, 512, {"capacity": 9},
                                   {"capacity": 3, "hit_ms": 0.1}])
def test_resolve_forms_match_reference(value):
    got, want = resolve_answer_cache_spec(value), JAC.resolve_answer_cache_spec(value)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.to_dict() == want.to_dict()


def test_resolve_and_parse_errors():
    spec = AnswerCacheSpec(capacity=3)
    assert resolve_answer_cache_spec(spec) is spec
    with pytest.raises(TypeError, match="answer_cache"):
        resolve_answer_cache_spec("big")
    opts = ["hit_ms=0.1", "idle_unload_ms=none", "capacity=7"]
    assert parse_answer_cache_opts(opts) == JAC.parse_answer_cache_opts(opts) == {
        "hit_ms": 0.1, "idle_unload_ms": None, "capacity": 7}
    with pytest.raises(ValueError, match="KEY=VALUE"):
        parse_answer_cache_opts(["hit_ms"])


# ---------------------------------------------------------------------------
# AnswerCache unit semantics, step for step against the reference's store
# ---------------------------------------------------------------------------

def _fill(caches, rs, base=0, k=K):
    b = rs.shape[0]
    d = np.tile(np.arange(1.0, k + 1, dtype=np.float32), (b, 1))
    ids = (base + np.arange(b * k, dtype=np.int32)).reshape(b, k)
    for c in caches:
        c.store_batch(rs, k, d, ids)
    return ids


def _both(capacity):
    return (AnswerCache(AnswerCacheSpec(capacity=capacity)),
            JAC.AnswerCache(JAC.AnswerCacheSpec(capacity=capacity)))


def _lookup_both(caches, rs, k=K, **kw):
    (pe, pm), (je, jm) = (c.lookup_batch(rs, k, **kw) for c in caches)
    np.testing.assert_array_equal(pm, jm)
    for a, b in zip(pe, je):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.d, b.d)
            assert a.kth == b.kth
            np.testing.assert_array_equal(AC._unpack(a.dev)[1].numpy().reshape(-1), b.ids)
    return pm


def _same_stats(caches):
    assert caches[0].stats() == caches[1].stats()


def test_store_lookup_lru_eviction(setup):
    catalog, _, _ = setup
    caches = _both(4)
    _fill(caches, catalog[:4])
    assert _lookup_both(caches, catalog[:4]).all()
    assert not _lookup_both(caches, catalog[:1], K + 1).any()  # another fan-out
    _fill(caches, catalog[4:6], base=100)
    assert not _lookup_both(caches, catalog[:2]).any()       # the two oldest left
    _same_stats(caches)
    assert caches[0].stats()["evictions"] >= 2


def test_peek_is_noncounting(setup):
    catalog, _, _ = setup
    caches = _both(8)
    _fill(caches, catalog[:2])
    for row, k in ((catalog[0], None), (catalog[0], K), (catalog[3], None),
                   (catalog[0], K + 2)):
        assert caches[0].peek(row, k) == caches[1].peek(row, k)
    _same_stats(caches)
    assert not AnswerCache(AnswerCacheSpec(capacity=0)).peek(catalog[0])


def test_invalidations_by_reason(setup):
    catalog, _, _ = setup
    caches = _both(16)
    ids = _fill(caches, catalog[:4])
    assert [c.invalidate_removed([int(ids[1, 2])]) for c in caches] == [1, 1]
    assert [c.invalidate_removed([10_000]) for c in caches] == [0, 0]
    _lookup_both(caches, catalog[:4])
    q = catalog[4:6]
    d = np.array([[0.1, 0.2, 0.3, 0.4]] * 2, np.float32)
    for c in caches:
        c.store_batch(q, K, d, np.arange(8, dtype=np.int32).reshape(2, 4) + 50)
    far = q[0] + 100.0
    assert [c.invalidate_added(far[None]) for c in caches] == [0, 0]
    got = [c.invalidate_added(q[0][None]) for c in caches]
    assert got[0] == got[1] >= 1
    under = (np.array([[0.1, np.inf, np.inf, np.inf]], np.float32),
             np.array([[3, -1, -1, -1]], np.int32))
    for c in caches:
        c.store_batch(q[:1], K, *under)
    assert [c.invalidate_added(far[None]) for c in caches] == [1, 1]
    sizes = [len(c) for c in caches]
    assert [c.flush("refresh") for c in caches] == sizes and sizes[0] > 0
    _same_stats(caches)
    masks = [c.take_step_stats(4) for c in caches]
    np.testing.assert_array_equal(masks[0][0], masks[1][0])
    assert masks[0][1] == masks[1][1]


def test_remap_ids_rewrites_entries_and_inverted_map(setup):
    catalog, _, _ = setup
    caches = _both(8)
    rs = np.asarray(catalog[:2], np.float32)
    d = np.array([[0.1, 0.2, np.inf], [0.3, 0.4, 0.5]], np.float32)
    ids = np.array([[5, 9, -1], [2, 9, 11]], np.int32)
    for c in caches:
        c.store_batch(rs, 3, d, ids)
    remap = np.full(16, -1, np.int32)
    for new, old in enumerate((2, 5, 9, 11)):
        remap[old] = new
    for c in caches:
        c.remap_ids(remap)
    assert _lookup_both(caches, rs, 3).all()
    assert [c.invalidate_removed([2]) for c in caches] == [2, 2]
    _same_stats(caches)
    for c in caches:
        c.store_batch(rs[:1], 3, d[:1], np.array([[0, 1, -1]], np.int32))
    bad = np.full(16, -1, np.int32)
    bad[0] = 0
    for c in caches:
        with pytest.raises(ValueError, match="dead row"):
            c.remap_ids(bad)
    _same_stats(caches)


def test_rid_namespace(setup):
    catalog, _, _ = setup
    caches = _both(8)
    d = np.zeros((2, K), np.float32)
    ids = np.arange(8, dtype=np.int32).reshape(2, 4)
    for c in caches:
        c.store_batch(catalog[:2], K, d, ids, rids=[17, 23])
    assert _lookup_both(caches, catalog[:2], rids=[17, 23]).all()
    assert _lookup_both(caches, catalog[10:12], rids=[17, 23]).all()
    assert not _lookup_both(caches, catalog[:2]).any()
    for c in caches:
        with pytest.raises(ValueError, match="rids length"):
            c.lookup_batch(catalog[:2], K, rids=[17])


# ---------------------------------------------------------------------------
# CachedIndex against the reference's, every backend, one mutation schedule
# ---------------------------------------------------------------------------

def _check_answers(got, want):
    gd, gi = (_np(a) for a in got)
    wd, wi = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("backend", sorted(TINY))
def test_cached_index_matches_reference(setup, backend):
    """The same query / add / remove / refresh / compact schedule through
    the port's CachedIndex and the reference's: answers, hit masks and
    invalidation counts by reason equal after every step."""
    catalog, reqs, newv = setup
    spec = dict(capacity=32)
    port = CachedIndex(build_index(IndexSpec(backend, port_params(backend)), catalog,
                                   device="cpu"), AnswerCacheSpec(**spec))
    ref = JAC.CachedIndex(jbuild(JSpec(backend, TINY[backend]), jnp.asarray(catalog)),
                          JAC.AnswerCacheSpec(**spec))

    def query(rs):
        _check_answers(port.query(rs, K), ref.query(rs, K))
        pm, _ = port.cache.take_step_stats(len(rs))
        jm, _ = ref.cache.take_step_stats(len(rs))
        np.testing.assert_array_equal(pm, jm)
        assert port.stats()["invalidations"] == ref.stats()["invalidations"]

    query(reqs[:8])
    query(reqs[:8])                              # all hits on both
    assert port.cache.scans_skipped == 1
    np.testing.assert_array_equal(port.add(newv), np.asarray(ref.add(jnp.asarray(newv))))
    query(reqs[:8])
    doomed = np.unique(np.asarray(ref.query(reqs[8:16], K)[1]))[:3]
    port.query(reqs[8:16], K)
    port.remove(doomed)
    ref.remove(doomed)
    query(reqs[8:16])
    query(reqs[:8])
    port.refresh()
    ref.refresh()
    query(reqs[:8])
    np.testing.assert_array_equal(port.compact(), ref.compact())
    query(reqs[:8])
    query(reqs[16:24])
    keys = ("hits", "misses", "stores", "evictions", "invalidations", "inv_remove",
            "inv_add", "inv_refresh", "scans", "scans_skipped", "epoch", "entries",
            "unloads", "reloads")
    assert {k: port.stats()[k] for k in keys} == {k: ref.stats()[k] for k in keys}


# ---------------------------------------------------------------------------
# the port's own pin: cache-on == pass-through, bitwise, every backend
# ---------------------------------------------------------------------------

def _served_recorder(pol, sink):
    idx = pol.cache.index
    orig = idx.query

    def wrapped(rs, k):
        d, ids = orig(rs, k)
        sink.append(_np(ids).copy())
        return d, ids

    idx.query = wrapped


@pytest.mark.parametrize("backend", sorted(TINY))
def test_bitwise_parity_under_churn(setup, backend):
    """Identical per-request gain, policy state and served ids with the
    cache on and in pass-through, through serve / add / remove / refresh,
    and no removed id served after its removal."""
    catalog, reqs, newv = setup
    ispec = IndexSpec(backend, port_params(backend))
    arms = {}
    for cap in (64, 0):
        pol = _policy(catalog, ispec, cap)
        served, gains = [], []
        _served_recorder(pol, served)
        for rs in (reqs[:8], reqs[:8]):
            gains.append(pol.serve_update_batch(rs).gain_int.numpy())
        pol.add_objects(newv)
        gains.append(pol.serve_update_batch(reqs[:8]).gain_int.numpy())
        doomed = np.unique(np.concatenate(served)[-8:])
        doomed = doomed[doomed >= 0][:3]
        pol.remove_objects(doomed)
        n_before = len(served)
        gains.append(pol.serve_update_batch(reqs[8:16]).gain_int.numpy())
        pol.refresh()
        gains.append(pol.serve_update_batch(reqs[:8]).gain_int.numpy())
        arms[cap] = (np.concatenate(gains), pol.cache.state.y.numpy(),
                     pol.cache.state.x.numpy(),
                     np.concatenate([s.ravel() for s in served]), pol, doomed,
                     np.concatenate([s.ravel() for s in served[n_before:]]))
    g_on, y_on, x_on, ids_on, pol_on, doomed, after = arms[64]
    g_off, y_off, x_off, ids_off, _, _, _ = arms[0]
    assert np.array_equal(g_on, g_off), f"{backend}: gain diverged"
    assert np.array_equal(y_on, y_off), f"{backend}: state.y diverged"
    assert np.array_equal(x_on, x_off), f"{backend}: state.x diverged"
    assert np.array_equal(ids_on, ids_off), f"{backend}: served ids diverged"
    assert not set(doomed.tolist()) & set(after.tolist())
    st = pol_on.answer_cache.stats()
    assert st["hits"] > 0 and st["invalidations"] > 0


@pytest.mark.parametrize("backend", sorted(TINY))
def test_bitwise_parity_under_compaction(setup, backend):
    """remove -> compact -> serve: flat remaps its stored answers (and they
    hit again), the structure-backed backends flush; either way the two
    arms serve bit for bit alike."""
    catalog, reqs, newv = setup
    ispec = IndexSpec(backend, port_params(backend))
    far = newv + 8.0
    arms = {}
    for cap in (64, 0):
        pol = _policy(catalog, ispec, cap)
        served, gains = [], []
        _served_recorder(pol, served)
        for rs in (reqs[:8], reqs[:8]):
            gains.append(pol.serve_update_batch(rs).gain_int.numpy())
        added = pol.add_objects(far)
        pol.remove_objects(added[:4])
        remap = pol.compact()
        entries = len(pol.answer_cache.cache)
        hits0 = pol.answer_cache.cache.hits
        gains.append(pol.serve_update_batch(reqs[:8]).gain_int.numpy())
        gains.append(pol.serve_update_batch(reqs[8:16]).gain_int.numpy())
        arms[cap] = (np.concatenate(gains), pol.cache.state.y.numpy(),
                     np.concatenate([s.ravel() for s in served]), remap, entries,
                     pol.answer_cache.cache.hits - hits0)
    g_on, y_on, ids_on, remap_on, entries_on, hits_on = arms[64]
    g_off, y_off, ids_off, remap_off, _, _ = arms[0]
    np.testing.assert_array_equal(remap_on, remap_off)
    assert np.array_equal(g_on, g_off), f"{backend}: gain diverged"
    assert np.array_equal(y_on, y_off), f"{backend}: state.y diverged"
    assert np.array_equal(ids_on, ids_off), f"{backend}: served ids diverged"
    if backend == "flat":
        assert entries_on > 0 and hits_on > 0
    else:
        assert entries_on == 0


def test_replay_matches_reference_with_injected_uniforms(setup):
    """AÇAI over flat with the answer tier, port against reference, the
    reference's rounding uniforms injected: per-request gain to 1e-5, and
    the answer counters exactly."""
    catalog, reqs, _ = setup
    jpol = JPA.build_policy(JPA.PolicySpec("acai", {"h": 32, "k": K, "batch": 8}),
                            jnp.asarray(catalog), JCostModel(c_f=0.3),
                            index_spec=JSpec("flat"), seed=0,
                            answer_cache=JAC.AnswerCacheSpec(capacity=64))
    pol = _policy(catalog, IndexSpec("flat"), 64)
    st = jpol.cache.state
    pol.cache.state = convert.cache_state_from_numpy(np.asarray(st.y), np.asarray(st.x),
                                                     int(st.t), device="cpu")
    us = reference_uniforms(st.key, st.y.shape[0], reqs.shape[0] // 8)
    got = pol.replay(reqs, uniforms=torch.from_numpy(us))
    want = jpol.replay(reqs)
    np.testing.assert_allclose(got["gain"], want["gain"], rtol=RTOL, atol=1e-5 * K * 0.3)
    np.testing.assert_array_equal(got["answer_hits"], want["answer_hits"])
    np.testing.assert_array_equal(got["served_local"], want["served_local"])
    assert pol.answer_cache.stats()["hits"] == jpol.answer_cache.stats()["hits"] > 0


def test_replay_parity_and_metrics(setup):
    catalog, reqs, _ = setup
    res = {cap: (_policy(catalog, IndexSpec("flat"), cap),) for cap in (64, 0)}
    res = {cap: (p[0].replay(reqs), p[0]) for cap, p in res.items()}
    (r_on, pol_on), (r_off, _) = res[64], res[0]
    assert np.array_equal(r_on["gain"], r_off["gain"])
    t = r_on["requests"]
    assert r_on["answer_hits"].shape == (t,) and r_on["answer_hits"].sum() > 0
    assert r_off["answer_hits"].sum() == 0
    st = pol_on.answer_cache.stats()
    assert st["hit_rate"] > 0 and st["scans_skipped"] > 0
    assert st["key_readbacks"] == 0  # the replay hands its host batches over


def test_metrics_leaf_shapes(setup):
    catalog, reqs, _ = setup
    pol = _policy(catalog, IndexSpec("flat"), 64)
    m = pol.serve_update_batch(reqs[:8])
    for f in ("answer_hits", "answer_misses", "answer_invalidations"):
        assert getattr(m, f).shape == (8,), f
    assert ((m.answer_hits + m.answer_misses) == 1).all()
    pol.answer_cache.cache._link()  # the inverted map is built when needed
    served_id = next(iter(pol.answer_cache.cache._inv))
    pol.remove_objects([served_id])
    m2 = pol.serve_update_batch(reqs[:8])
    assert int(m2.answer_invalidations.sum()) > 0


def test_build_policy_validation(setup):
    catalog, _, _ = setup
    cm = CostModel(c_f=0.3)
    with pytest.raises(ValueError, match="oracle-exact"):
        PA.build_policy(PA.PolicySpec("lru", {"h": 16, "k": K}), catalog, cm,
                        answer_cache=AnswerCacheSpec(), device="cpu")
    with pytest.raises(ValueError, match="cfg.index"):
        PA.build_policy(PA.PolicySpec("acai", {"h": 16, "k": K}), catalog, cm,
                        answer_cache=AnswerCacheSpec(), device="cpu")
    from repro_torch.core import policy as tpol

    cfg = tpol.AcaiConfig(h=8, k=K, c_remote=12, c_local=8)
    with pytest.raises(ValueError, match="explicit candidate_fn"):
        tpol.AcaiCache(catalog, cfg, device="cpu", answer_cache=8,
                       candidate_fn_batched=lambda rs, x: None)
    pol = _policy(catalog, IndexSpec("flat"), 8)
    assert isinstance(pol.answer_cache, CachedIndex) and pol.cache._mutated


# ---------------------------------------------------------------------------
# interleavings: never serve a removed id, always match the exact scan
# ---------------------------------------------------------------------------

def _check_interleaving(ops, catalog):
    cached = CachedIndex(build_index(IndexSpec("flat"), catalog, device="cpu"),
                         AnswerCacheSpec(capacity=32))
    exact = build_index(IndexSpec("flat"), catalog, device="cpu")
    live = set(range(catalog.shape[0]))
    dead: set = set()
    for op, seed in ops:
        rng = np.random.default_rng(seed)
        if op == "query":
            rows = catalog[rng.integers(0, catalog.shape[0], 3)]
            d_c, i_c = cached.query(rows, K)
            d_e, i_e = exact.query(torch.from_numpy(rows), K)
            assert torch.equal(i_c, i_e) and torch.equal(d_c, d_e)
            assert not (set(i_c.flatten().tolist()) - {-1}) & dead
        elif op == "add":
            v = rng.random((1 + seed % 3, catalog.shape[1]), dtype=np.float32)
            got = cached.add(v)
            np.testing.assert_array_equal(got, exact.add(v))
            live |= set(got.tolist())
        elif op == "remove" and len(live) > 4:
            victims = rng.choice(sorted(live), size=min(2, len(live) - 4), replace=False)
            cached.remove(victims)
            exact.remove(victims)
            live -= set(victims.tolist())
            dead |= set(victims.tolist())
        elif op == "refresh":
            cached.refresh()
            exact.refresh()


_SCHEDULES = [
    [("query", 0), ("add", 1), ("query", 2), ("remove", 3), ("query", 4),
     ("refresh", 0), ("query", 5)],
    [("query", 7), ("query", 7), ("remove", 8), ("remove", 9),
     ("query", 10), ("add", 11), ("add", 12), ("query", 13)],
    [("remove", 1), ("refresh", 0), ("query", 2), ("query", 2),
     ("add", 3), ("remove", 4), ("query", 5)],
]


@pytest.mark.parametrize("schedule", range(len(_SCHEDULES)))
def test_interleaving_seeded(setup, schedule):
    catalog, _, _ = setup
    _check_interleaving(_SCHEDULES[schedule], catalog[:60])


def test_interleaving_property(setup):
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    catalog, _, _ = setup
    ops = st.lists(st.tuples(st.sampled_from(["query", "add", "remove", "refresh"]),
                             st.integers(0, 2 ** 16)), min_size=1, max_size=16)

    @settings(max_examples=25, deadline=None)
    @given(ops=ops)
    def run(ops):
        _check_interleaving(ops, catalog[:60])

    run()


# ---------------------------------------------------------------------------
# engine fast path, idle unload, key hashing
# ---------------------------------------------------------------------------

def test_engine_fast_path_matches_reference(setup):
    """The arrival-time fast path: the learn path is untouched (cache-on
    gains equal pass-through's bit for bit), the hit flags and timestamps
    equal the reference engine's exactly."""
    from repro.serve.arrivals import ArrivalSpec as JArrival
    from repro.serve.queue import BatchFormerConfig as JFormer
    from repro.serve.queue import OnlineServingEngine as JEngine
    from repro.serve.queue import ServiceModel as JService
    from repro_torch.serve.arrivals import ArrivalSpec
    from repro_torch.serve.queue import (BatchFormerConfig, OnlineServingEngine,
                                         ServiceModel)

    catalog, reqs, _ = setup
    service = ServiceModel()
    arrival = ArrivalSpec(kind="poisson", rate_rps=0.7 * service.capacity_rps(8), seed=2)
    runs = {}
    for cap in (64, 0):
        pol = _policy(catalog, IndexSpec("flat"), cap, hit_ms=0.25)
        eng = OnlineServingEngine(pol, former=BatchFormerConfig(max_batch=8,
                                                                max_wait_ms=4.0),
                                  service=service)
        runs[cap] = eng.run(reqs, arrival)
    on, off = runs[64], runs[0]
    assert np.array_equal(on["gain"], off["gain"])
    assert on["answer_hit_rate"] > 0 and off["answer_hit_rate"] == 0
    assert np.allclose(on["user_latency_ms"][on["answer_hit"]], 0.25)
    miss = ~on["answer_hit"] & ~on["shed"]
    assert np.array_equal(on["user_latency_ms"][miss], on["latency_ms"][miss])
    jpol = JPA.build_policy(JPA.PolicySpec("acai", {"h": 32, "k": K, "batch": 8}),
                            jnp.asarray(catalog), JCostModel(c_f=0.3),
                            index_spec=JSpec("flat"), seed=0,
                            answer_cache=JAC.AnswerCacheSpec(capacity=64, hit_ms=0.25))
    want = JEngine(jpol, former=JFormer(max_batch=8, max_wait_ms=4.0),
                   service=JService()).run(reqs, JArrival(
                       kind="poisson", rate_rps=0.7 * JService().capacity_rps(8), seed=2))
    for f in ("answer_hit", "arrival_ms", "form_ms", "done_ms", "user_latency_ms"):
        np.testing.assert_array_equal(on[f], want[f], err_msg=f)
    assert on["batch_hist"] == want["batch_hist"]


@pytest.mark.parametrize("backend", ["ivf", "ivfpq", "lsh", "nsw"])
def test_idle_unload_reload_bitwise(setup, backend):
    """tick() past the idle threshold offloads every structure tensor but
    the slab and its mask (a PQ codec's codebooks included); hits serve
    while unloaded; the first miss reloads them to the device they came
    from, and every answer equals a never-unloaded twin's bit for bit.
    PR 18's no-reallocation guard (`data_ptr`) holds for the slab and the
    mask, which stay; the reloaded tensors are new allocations, so the
    guard restarts from them."""
    catalog, _, _ = setup
    params = port_params(backend)
    ci = CachedIndex(build_index(IndexSpec(backend, params), catalog, device="cpu"),
                     AnswerCacheSpec(capacity=32, idle_unload_ms=10.0))
    twin = CachedIndex(build_index(IndexSpec(backend, params), catalog, device="cpu"),
                       AnswerCacheSpec(capacity=32))
    hot, cold = catalog[:8], catalog[8:16]
    ref_hot, ref_cold = twin.query(hot, K), twin.query(cold, K)
    emb_ptr, valid_ptr = ci.embeddings.data_ptr(), ci.valid.data_ptr()
    ci.query(hot, K)
    ci.tick(5.0)
    assert ci.loaded
    ci.tick(20.0)
    assert not ci.loaded and ci.unloads == 1
    moved = {(name, sub) for name, sub, _ in ci._offloaded}
    assert ("embeddings", None) not in moved and ("valid", None) not in moved
    if backend == "ivfpq":
        assert {("codec", "codebooks"), ("codes_lists", None), ("invlists", None),
                ("centroids", None)} <= moved
    assert ci.last_unload_nbytes > 0
    got = ci.query(hot, K)
    assert not ci.loaded
    assert all(torch.equal(a, b) for a, b in zip(got, ref_hot))
    got2 = ci.query(cold, K)
    assert ci.loaded and ci.reloads == 1
    assert all(torch.equal(a, b) for a, b in zip(got2, ref_cold))
    got3 = ci.query(hot, K)
    assert all(torch.equal(a, b) for a, b in zip(got3, ref_hot))
    assert (ci.embeddings.data_ptr(), ci.valid.data_ptr()) == (emb_ptr, valid_ptr)
    st = ci.stats()
    assert st["unloads"] == 1 and st["reloads"] == 1
    # a mutation on an unloaded index reloads it first
    ci.tick(100.0)
    assert not ci.loaded
    ci.add(catalog[:1] + 0.5)
    assert ci.loaded and ci.reloads == 2


def test_capacity_zero_never_stores_nor_hashes(setup):
    catalog, _, _ = setup
    ci = CachedIndex(build_index(IndexSpec("flat"), catalog, device="cpu"),
                     AnswerCacheSpec(capacity=0))
    for _ in range(3):
        ci.query(catalog[:4], K)
    st = ci.stats()
    assert st["entries"] == 0 and st["hits"] == 0
    assert st["scans"] == 3 and st["scans_skipped"] == 0


def test_keys_hash_the_host_bytes(setup):
    """The key is the blake2b digest of the float32 bytes: a staged host
    copy and the same rows given as a tensor hash alike, and the
    reference's digest is the port's."""
    catalog, _, _ = setup
    row = catalog[3]
    assert AC._vector_key(row) == JAC._vector_key(row)
    ci = CachedIndex(build_index(IndexSpec("flat"), catalog, device="cpu"),
                     AnswerCacheSpec(capacity=8))
    first = ci.query(torch.from_numpy(catalog[:4]), K)
    ci.stage(catalog[:4])
    again = ci.query(torch.from_numpy(catalog[:4]), K)
    assert ci.cache.hits == 4 and ci.key_readbacks == 0
    # a repeated batch is handed back as stored; other all-hit batches are
    # joined row by row, bitwise the same rows
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    stored = ci.cache._store[next(iter(ci.cache._store))].batch
    assert again[0].untyped_storage().data_ptr() == stored.untyped_storage().data_ptr()
    mixed = ci.query(catalog[[2, 0, 3]], K)
    assert torch.equal(mixed[1], first[1][[2, 0, 3]])
    assert torch.equal(mixed[0], first[0][[2, 0, 3]])
