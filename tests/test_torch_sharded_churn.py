"""Port parity of the sharded mutable catalog (repro_torch.core.distributed's
mutable step, owner routing and slab append, `AcaiCache(mesh=)` under
churn) against repro.core.distributed and the port's single-device path.

One rank runs in this process (bit for bit against the single-device
path, and to float32 tolerance against the reference with its k_round
uniforms); two ranks are a spawned gloo world
(`torch_dist_workers`), where the invalidation invariant, the projection's
heavy-removal edge, compaction and the answer cache's remap are checked
across real shards.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import churn as jchurn
from repro.core import distributed as jd
from repro.core import oma as joma
from repro.core import policy as jpol
from repro.core import trace as jtrace
from repro_torch import convert
from repro_torch.core import churn as tchurn
from repro_torch.core import distributed as D
from repro_torch.core import oma as toma
from repro_torch.core import policy as tpol
from repro_torch.index.base import slab_append
from torch_dist_workers import host_mesh, jobs_rank, run_world  # noqa: F401

RTOL = 1e-5
D_ = 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(rounding="coupled"):
    # projection_topk == the sharded step's top_a: the bitwise precondition
    kw = dict(h=16, k=4, c_f=1.0, c_remote=16, c_local=8)
    return (jpol.AcaiConfig(**kw, oma=joma.OMAConfig(eta=0.01, projection_topk=48,
                                                     rounding=rounding)),
            tpol.AcaiConfig(**kw, oma=toma.OMAConfig(eta=0.01, projection_topk=48,
                                                     rounding=rounding)))


class RefUniforms:
    """uniforms_fn(i, n): the reference cache's rounding uniforms of step i
    over n rows (k_round of the i-th split of its state key)."""

    def __init__(self, key):
        self.key, self.rounds = key, []

    def __call__(self, i: int, n: int):
        while len(self.rounds) <= i:
            self.key, k_round = jax.random.split(self.key)
            self.rounds.append(k_round)
        return np.array(jax.random.uniform(self.rounds[i], (n,), dtype=jnp.float32))


@pytest.fixture(scope="module")
def rolling():
    params = dict(jtrace.TINY_TRACE_KWARGS["rolling_catalog"])
    catalog, reqs, _ = jtrace.build_trace("rolling_catalog", **params)
    events = jtrace.rolling_catalog_events(**params)
    return catalog, reqs, events, jchurn.warm_size(params["n"], params["warm"])


# ---------------------------------------------------------------------------
# one rank: the reference's (1, 1) mesh and the port's single-device path
# ---------------------------------------------------------------------------

def test_mutable_step_sharded_matches_reference_with_tombstones(host_mesh):
    """One step with 40 tombstoned rows: make_mutable_step_sharded on one
    rank against the reference's on jax.make_mesh((1, 1)), same state and
    k_round uniforms: y to 1e-5, x, served flags and fetched equal."""
    jcfg, tcfg = _cfgs()
    n = 128
    cat = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (n, D_)))
    alive = np.ones(n, bool)
    alive[:40] = False
    st = jpol.init_state(n, jcfg, seed=3)
    st = jpol.CacheState(jnp.where(alive, st.y, 0.0), jnp.where(alive, st.x, 0.0), st.t,
                         st.key)
    rs = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (8, D_)))
    j_st, j_m = jd.make_mutable_step_sharded(jcfg, jax.make_mesh((1, 1), ("data", "model")),
                                             8)(st, jnp.asarray(rs), jnp.asarray(cat),
                                                jnp.asarray(alive))
    u = RefUniforms(st.key)(0, n)
    t_st, t_m = D.make_mutable_step_sharded(tcfg, host_mesh, 8)(
        convert.cache_state_from_numpy(st.y, st.x, device="cpu"), _t(rs), _t(cat),
        _t(alive), _t(u))
    np.testing.assert_allclose(t_st.y.numpy(), np.asarray(j_st.y), rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(t_st.x.numpy(), np.asarray(j_st.x))
    assert t_st.t == int(j_st.t) == 8
    np.testing.assert_allclose(t_m.gain_int.numpy(), np.asarray(j_m.gain_int), rtol=RTOL,
                               atol=1e-5 * tcfg.k)
    for f in ("served_local", "fetched", "occupancy"):
        np.testing.assert_array_equal(getattr(t_m, f).numpy(), np.asarray(getattr(j_m, f)),
                                      err_msg=f)
    assert float(t_st.y[:40].abs().sum()) == 0.0


def test_churn_replay_on_one_rank(host_mesh, rolling):
    """replay_with_churn, unchanged, drives AcaiCache(mesh=): adds,
    removals, capacity growth and compaction on one rank are bit for bit
    the cache without a mesh (metrics, y, x, the slab and its mask), and
    match the reference's cache on its uniforms (the reference's own (1,
    1)-mesh cache is bitwise its plain one; its mesh path's growth scatter
    does not run under the installed JAX)."""
    catalog, reqs, events, n0 = rolling
    jcfg, tcfg = _cfgs()
    plain = tpol.AcaiCache(catalog[:n0], tcfg, seed=0, device="cpu")
    shard = tpol.AcaiCache(catalog[:n0], tcfg, seed=0, mesh=host_mesh)
    res_p = tchurn.replay_with_churn(plain, catalog, reqs, events, batch=8, compact_every=24)
    res_s = tchurn.replay_with_churn(shard, catalog, reqs, events, batch=8, compact_every=24)
    assert res_p["compactions"] == res_s["compactions"] > 0
    for k in ("gain", "served_local", "occupancy", "fetched", "cost"):
        np.testing.assert_array_equal(res_p[k], res_s[k], err_msg=k)
    assert torch.equal(plain.state.y, shard.state.y)
    assert torch.equal(plain.state.x, shard.state.x)
    assert torch.equal(plain.valid, shard.valid) and torch.equal(plain.catalog, shard.catalog)
    # against the reference's cache, on its uniforms
    jc = jpol.AcaiCache(jnp.asarray(catalog[:n0]), jcfg, seed=0)
    tc = tpol.AcaiCache(catalog[:n0], tcfg, mesh=host_mesh,
                        state=convert.cache_state_from_numpy(jc.state.y, jc.state.x,
                                                             device="cpu"))
    uniforms = RefUniforms(jc.state.key)
    want = jchurn.replay_with_churn(jc, catalog, reqs, events, batch=8, compact_every=24)
    got = tchurn.replay_with_churn(tc, catalog, reqs, events, batch=8, compact_every=24,
                                   uniforms_fn=uniforms)
    np.testing.assert_allclose(got["gain"], want["gain"], rtol=RTOL, atol=1e-5 * tcfg.k)
    for k in ("served_local", "fetched", "occupancy"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert got["compactions"] == want["compactions"]
    np.testing.assert_array_equal(tc.state.x.numpy(), np.asarray(jc.state.x))
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))


def _slab_case():
    rng = np.random.default_rng(0)
    return {"vecs": rng.standard_normal((70, D_)).astype(np.float32),
            "emb": rng.standard_normal((128, D_)).astype(np.float32),
            "valid": np.arange(128) < 100, "n_slots": 100}


def _reference_slab(case, p):
    emb, valid, ids = jd.sharded_slab_append(jnp.asarray(case["emb"]),
                                             jnp.asarray(case["valid"]), case["n_slots"],
                                             case["vecs"], p)
    return np.asarray(emb), np.asarray(valid), ids


def test_sharded_slab_append_one_rank(host_mesh):
    """At P = 1 sharded_slab_append is the port's slab_append bit for bit,
    growth schedule included, and the reference's sharded_slab_append."""
    case = _slab_case()
    e1, v1, i1 = slab_append(_t(case["emb"]), _t(case["valid"]), case["n_slots"],
                             _t(case["vecs"]))
    e2, v2, i2, (y2,) = D.sharded_slab_append(_t(case["emb"]), _t(case["valid"]),
                                              case["n_slots"], case["vecs"], host_mesh,
                                              carry=(torch.ones(128),))
    assert torch.equal(e1, e2) and torch.equal(v1, v2)
    np.testing.assert_array_equal(i1, i2)
    assert y2.shape == (256,) and float(y2.sum()) == 128.0
    emb, valid, ids = _reference_slab(case, 1)
    np.testing.assert_array_equal(e2.numpy(), emb)
    np.testing.assert_array_equal(v2.numpy(), valid)
    np.testing.assert_array_equal(i2, ids)


def _assert_roundtrip(ids, cap, p):
    groups = D.route_ids_by_owner(ids, cap, p)
    shards = [s for s, _ in groups]
    assert shards == sorted(set(shards))
    block = cap // p
    back = []
    for s, gids in groups:
        assert ((gids >= s * block) & (gids < (s + 1) * block)).all()
        assert gids.tolist() == [i for i in ids if s * block <= i < (s + 1) * block]
        back.extend(gids.tolist())
    assert sorted(back) == sorted(ids)


def test_owner_routing_roundtrip_property():
    """Owner routing partitions a batch by owner block, keeps each group's
    order, and concatenates back to a permutation of the input."""
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=60, deadline=None)
    @given(st.integers(0, 4).map(lambda e: 2 ** e), st.integers(0, 6),
           st.lists(st.integers(0, 1023), min_size=0, max_size=40))
    def prop(p, cap_pow, raw):
        cap = p * (2 ** cap_pow)
        _assert_roundtrip([i % cap for i in raw], cap, p)

    prop()
    assert [(0, [7, 3, 7])] == [(s, g.tolist()) for s, g in
                                D.route_ids_by_owner([7, 3, 7], 64, 1)]


def test_mutable_sharded_rejects_non_negentropy(host_mesh):
    _, tcfg = _cfgs()
    euclid = dataclasses.replace(tcfg, oma=dataclasses.replace(tcfg.oma, mirror="euclidean"))
    with pytest.raises(NotImplementedError, match="negentropy"):
        D.make_mutable_step_sharded(euclid, host_mesh, 8)


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(rolling, tmp_path_factory):
    data = {"removed": [3, 40, 70, 101], "rolling": rolling, "slab": _slab_case()}
    ranks = run_world(jobs_rank, (1, 2), tmp_path_factory.mktemp("churn2"),
                      [("churn", data)])
    return [r["churn"] for r in ranks]


def test_removed_never_served_across_shards(two_ranks):
    """Rows removed from both owners hold zero y and x through every later
    sharded update; no rank caches one; occupancy stays within h."""
    removed = [3, 40, 70, 101]
    for r in two_ranks:
        assert r["owners"] == [0, 1]
        assert r["removed_zero"]
        assert r["occupancy"] <= 16 + 1e-6
        assert r["live"] == 128 - len(removed)
        assert not np.intersect1d(r["cached"], removed).size


def test_all_tombstoned_shard_projection_edge(two_ranks):
    """One shard all tombstoned, the other below top-A: the projection's
    zero-padded heads keep the water level finite, dead mass stays dead."""
    for r in two_ranks:
        assert r["edge_live"] == 8
        assert np.isfinite(r["edge_y"]).all()
        assert float(np.abs(r["edge_y"][8:]).sum()) == 0.0
        assert r["edge_gain_finite"] and r["edge_occupancy"] <= 16 + 1e-6


def test_churn_replay_on_two_ranks(two_ranks, rolling):
    """The rolling-catalog replay with compaction on two ranks: every event
    applies, the slab stays a multiple of the mesh, the live window ends
    where the schedule does, and both ranks report the same gains."""
    _, _, events, n0 = rolling
    a, b = two_ranks
    for r in (a, b):
        rep = r["replay"]
        assert rep["events_applied"] == len(events) and rep["compactions"] > 0
        assert rep["live"] == n0 and rep["cap"] % 2 == 0 and rep["gain_finite"]
    np.testing.assert_array_equal(a["replay"]["gain"], b["replay"]["gain"])


def test_compaction_remap_consistent_with_answer_cache(two_ranks):
    """A sharded compaction's remap pushed through AnswerCache.remap_ids
    keeps every stored id on the row that holds the same embedding, and the
    inverted map consistent; the new capacity is mesh-aligned."""
    for r in two_ranks:
        assert r["ac_invalidated"] == 0
        assert r["ac_ok"] and r["ac_inv_ok"]
        assert r["compact_cap"] % 2 == 0


def test_mesh_mutation_guards(two_ranks):
    """The scan_chunk path refuses mutation before touching anything."""
    for r in two_ranks:
        assert r["guard"] is not None and "exact masked scan" in r["guard"]
        assert r["guard_untouched"]


def test_sharded_slab_append_two_ranks_matches_reference(two_ranks):
    """sharded_slab_append over two ranks, gathered, against the reference's
    at P = 2: the batch straddling the blocks, growth mesh-aligned, ids
    monotonic, carried rows moved to their owners."""
    case = _slab_case()
    emb, valid, ids = _reference_slab(case, 2)
    for r in two_ranks:
        s = r["slab"]
        np.testing.assert_array_equal(s["emb"], emb)
        np.testing.assert_array_equal(s["valid"], valid)
        np.testing.assert_array_equal(s["ids"], np.arange(100, 170))
        np.testing.assert_array_equal(s["ids"], ids)
        assert s["emb"].shape[0] % 2 == 0
