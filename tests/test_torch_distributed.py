"""Port parity of the sharded AÇAI step (repro_torch.core.distributed)
against repro.core.distributed, on torch.distributed gloo ranks.

A one-rank world runs in this process (the (1, 1) mesh: bit for bit
against the port's single-device step, and held to the reference's
functions on the same numpy inputs); worlds of 2, 4 and 8 ranks are
spawned processes (`torch_dist_workers.run_world`: a file store under the
test's tmp_path and a time limit a world), which never import JAX: the
reference's side is computed here and handed over as numpy arrays.

Tolerances: float32 across packages to 1e-5 relative (y of the retrieval
step within 2e-4 and equal answer sets, the reference's own limits in
tests/test_distributed_acai.py); within the port, a (1, 1) mesh equal to
the single-device step bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jd
from repro.core import oma as joma
from repro.core import policy as jpol
from repro_torch import convert
from repro_torch.core import distributed as D
from repro_torch.core import oma as toma
from repro_torch.core import policy as tpol
from repro_torch.core import trace as ttrace
from repro_torch.index.base import IndexSpec, build_index
from torch_dist_workers import (budgets_rank, host_mesh, jobs_rank,  # noqa: F401
                                run_world, serving_rank)

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def reference_uniforms(key, n: int, steps: int) -> np.ndarray:
    """(steps, n) coupled-rounding uniforms as the reference draws them:
    key, k_round = split(key) a step, uniform(k_round, (n,))."""
    out = np.empty((steps, n), np.float32)
    for i in range(steps):
        key, k_round = jax.random.split(key)
        out[i] = np.asarray(jax.random.uniform(k_round, (n,), dtype=jnp.float32))
    return out


def _cfgs(h=48, k=8, a=2 * 48 + 64, **kw):
    base = dict(h=h, k=k, c_f=1.0, c_remote=32, c_local=16)
    return (jpol.AcaiConfig(**base, oma=joma.OMAConfig(eta=0.05, projection_topk=a, **kw)),
            tpol.AcaiConfig(**base, oma=toma.OMAConfig(eta=0.05, projection_topk=a, **kw)))


# ---------------------------------------------------------------------------
# building blocks against the reference's (size-1 batch axis)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked,denom", [(False, 1.0), (True, 1.0), (False, 8.0),
                                          (True, 8.0)])
def test_payload_and_routing_match_reference(host_mesh, masked, denom):
    """_candidate_payload and _route_subgradients on a one-rank batch axis
    against the reference's functions (which exchange nothing there)."""
    rng = np.random.default_rng(3)
    b, c, n_s, off, n = 8, 12, 40, 40, 160
    d = rng.random((b, c)).astype(np.float32)
    loc = np.stack([rng.permutation(n_s)[:c] for _ in range(b)]).astype(np.int32)
    miss = rng.random((b, c)) < 0.2
    y = rng.random(n_s).astype(np.float32)
    x = (rng.random(n_s) < 0.5).astype(np.float32)
    want = np.asarray(jd._candidate_payload(jnp.asarray(d), jnp.asarray(loc),
                                            jnp.asarray(miss), off, n, jnp.asarray(y),
                                            jnp.asarray(x)))
    got = D._candidate_payload(_t(d), _t(loc), _t(miss), off, n, _t(y), _t(x)).numpy()
    np.testing.assert_array_equal(got[..., [0, 2, 3]], want[..., [0, 2, 3]])
    np.testing.assert_array_equal(got[..., 1].view(np.int32), want[..., 1].view(np.int32))
    # routing: ids across three shards' blocks, some invalid
    ids = (loc + rng.integers(0, 3, (b, 1)) * n_s).astype(np.int32)
    g = rng.random((b, c)).astype(np.float32)
    valid = rng.random((b, c)) < 0.7 if masked else None
    want = np.asarray(jd._route_subgradients(
        jnp.asarray(g), jnp.asarray(ids), None if valid is None else jnp.asarray(valid),
        off, n_s, ("data",), 1, denom))
    got, extra = D._route_subgradients(_t(g), _t(ids), None if valid is None else _t(valid),
                                       off, n_s, host_mesh, ("data",), 1, denom)
    assert extra is None
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cap,p", [(64, 1), (64, 2), (256, 4), (1024, 8)])
def test_owner_routing_matches_reference(cap, p):
    rng = np.random.default_rng(cap + p)
    ids = rng.integers(0, cap, 37).astype(np.int32)
    np.testing.assert_array_equal(D.owner_shard(ids, cap, p), jd.owner_shard(ids, cap, p))
    got, want = D.route_ids_by_owner(ids, cap, p), jd.route_ids_by_owner(ids, cap, p)
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, a), (_, w) in zip(got, want):
        np.testing.assert_array_equal(a, w)
    with pytest.raises(ValueError, match="divide"):
        D.owner_shard([0], cap + 1, 2)


# ---------------------------------------------------------------------------
# (1, 1): bit for bit against the port's single-device step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["step", "replay", "mutable"])
@pytest.mark.parametrize("b", [1, 8])
def test_sharded_steps_bitwise_at_one_rank(host_mesh, kind, b):
    """On a (1, 1) mesh with top_a == projection_topk: make_step_sharded,
    make_replay_sharded and make_mutable_step_sharded give the state and
    every metric of make_step_batched + exact candidates and
    make_mutable_step, bit for bit."""
    _, cfg = _cfgs()
    cat, reqs, _ = ttrace.sift_like(n=800, d=16, t=64, seed=0)
    cat, reqs = _t(cat), _t(reqs)
    s0 = tpol.init_state(800, cfg, device="cpu")
    a = cfg.oma.projection_topk
    if kind == "mutable":
        alive = torch.ones(800, dtype=torch.bool)
        alive[torch.randperm(800, generator=torch.Generator().manual_seed(1))[:40]] = False
        s0 = tpol.CacheState(torch.where(alive, s0.y, 0.0), torch.where(alive, s0.x, 0.0),
                             0, s0.gen)
        ref, shd = tpol.make_mutable_step(cfg, b), D.make_mutable_step_sharded(
            cfg, host_mesh, b, top_a=a)
        sa, sb = tpol.copy_state(s0), tpol.copy_state(s0)
        for i in range(0, 32, b):
            rs = reqs[i:i + b]
            ids, dd, valid = tpol.exact_mutable_candidates(rs, sa.x, cat, alive,
                                                           cfg.c_remote, cfg.c_local)
            sa, ma = ref(sa, ids, dd, valid, alive)
            sb, mb = shd(sb, rs, cat, alive)
            for f in tpol.StepMetrics._fields[:6]:
                assert torch.equal(getattr(ma, f), getattr(mb, f)), f
    elif kind == "replay":
        fnb = tpol.exact_candidate_fn_batched(cat, cfg.c_remote, cfg.c_local)
        sa, ma = tpol.make_replay_batched(cfg, fnb, b)(tpol.copy_state(s0), reqs)
        sb, mb = D.make_replay_sharded(cfg, host_mesh, cat, b, top_a=a)(
            tpol.copy_state(s0), reqs)
        for f in tpol.StepMetrics._fields[:6]:
            assert torch.equal(getattr(ma, f), getattr(mb, f)), f
    else:
        fnb = tpol.exact_candidate_fn_batched(cat, cfg.c_remote, cfg.c_local)
        ref, shd = tpol.make_step_batched(cfg, fnb, b), D.make_step_sharded(
            cfg, host_mesh, cat, b, top_a=a)
        sa, sb = tpol.copy_state(s0), tpol.copy_state(s0)
        for i in range(0, 32, b):
            sa, ma = ref(sa, reqs[i:i + b])
            sb, mb = shd(sb, reqs[i:i + b])
            for f in tpol.StepMetrics._fields[:6]:
                assert torch.equal(getattr(ma, f), getattr(mb, f)), f
    assert torch.equal(sa.y, sb.y) and torch.equal(sa.x, sb.x) and sa.t == sb.t


def test_collective_budgets_at_one_rank(host_mesh):
    """(1, 1): the exact and the mutable step spend the merge and the
    projection gathers and the rounding reduction; the IVF and scan_chunk
    paths one merge gather more; counts are a dict by primitive."""
    res = budgets_rank(host_mesh, 0, _budget_data())
    assert res["exact"] == (3, {"all_gather": 2, "all_reduce": 1})
    assert res["mutable"] == res["exact"]
    assert res["wide"] == res["exact"]
    assert res["ivf"] == res["chunk"] == (4, {"all_gather": 3, "all_reduce": 1})
    assert res["retrieval"] == (2, {"all_gather": 2})
    for total, counts in res.values():
        assert total == sum(counts.values())
        assert all(isinstance(v, int) and v > 0 for v in counts.values())


def test_depround_gathers_on_the_steps_it_fires(host_mesh):
    """DepRound couples the whole vector: on a (1, 1) mesh its sharded step
    equals the single-device one bit for bit, and spends one gather more on
    the steps where it fires (every second batch at round_every 16, B 8)."""
    _, cfg = _cfgs(rounding="depround", round_every=16)
    cat, reqs, _ = ttrace.sift_like(n=400, d=16, t=32, seed=2)
    cat, reqs = _t(cat), _t(reqs)
    s0 = tpol.init_state(400, cfg, device="cpu")
    fnb = tpol.exact_candidate_fn_batched(cat, cfg.c_remote, cfg.c_local)
    ref, shd = tpol.make_step_batched(cfg, fnb, 8), D.make_step_sharded(cfg, host_mesh,
                                                                        cat, 8)
    sa, sb = tpol.copy_state(s0), tpol.copy_state(s0)
    gathers = []
    for i in range(0, 32, 8):
        sa, _ = ref(sa, reqs[i:i + 8])
        D.reset_collectives()
        sb, _ = shd(sb, reqs[i:i + 8])
        gathers.append(D.COLLECTIVES["all_gather"])
        assert torch.equal(sa.x, sb.x) and torch.equal(sa.y, sb.y)
    assert gathers == [3, 2, 3, 2]


def test_acai_cache_mesh_matches_reference(host_mesh):
    """AcaiCache(mesh=) on one rank against the reference's AcaiCache on a
    (1, 1) mesh, with the reference's k_round uniforms: serve_update and
    serve_update_batch give the same y, x and metrics (to float32
    tolerance; served_local, x and fetched equal)."""
    jcfg, tcfg = _cfgs(h=32, k=4)
    cat, reqs, _ = ttrace.sift_like(n=400, d=16, t=32, seed=1)
    jc = jpol.AcaiCache(jnp.asarray(cat), jcfg, seed=0, mesh=jax.make_mesh((1, 1),
                                                                          ("data", "model")))
    tc = tpol.AcaiCache(cat, tcfg, mesh=host_mesh,
                        state=convert.cache_state_from_numpy(jc.state.y, jc.state.x,
                                                             device="cpu"))
    us = reference_uniforms(jc.state.key, 400, 6)
    jm = jc.serve_update(jnp.asarray(reqs[0]))
    tm = tc.serve_update(_t(reqs[0]), _t(us[0]))
    assert tm.gain_int.dim() == 0
    np.testing.assert_allclose(float(tm.gain_int), float(jm.gain_int), rtol=RTOL, atol=1e-5)
    for step, i in enumerate(range(1, 33 - 8, 8), start=1):
        jm = jc.serve_update_batch(jnp.asarray(reqs[i:i + 8]))
        tm = tc.serve_update_batch(_t(reqs[i:i + 8]), _t(us[step]))
        np.testing.assert_allclose(tm.gain_int.numpy(), np.asarray(jm.gain_int), rtol=RTOL,
                                   atol=1e-5 * tcfg.k)
        np.testing.assert_array_equal(tm.served_local.numpy(), np.asarray(jm.served_local))
        np.testing.assert_array_equal(tm.fetched.numpy(), np.asarray(jm.fetched))
        np.testing.assert_array_equal(tm.occupancy.numpy(), np.asarray(jm.occupancy))
        np.testing.assert_allclose(tc.state.y.numpy(), np.asarray(jc.state.y), rtol=RTOL,
                                   atol=1e-6)
        np.testing.assert_array_equal(tc.state.x.numpy(), np.asarray(jc.state.x))
    assert tc.state.t == int(jc.state.t) == 25
    assert abs(float(tc.state.y.sum()) - tcfg.h) < 1e-2


def test_policy_replay_on_a_mesh_is_the_single_device_replay(host_mesh):
    """build_policy(mesh=) replays through the sharded step: on one rank
    the same gains, x and occupancy as without the mesh, uniforms injected
    (a spec has no projection_topk, so the single-device step projects by
    the full sort and the sharded one over the top 2h + 64: y agrees to
    float32 tolerance)."""
    from repro_torch.core.costs import CostModel
    from repro_torch.core.policy_api import PolicySpec, build_policy

    cat, reqs, _ = ttrace.sift_like(n=300, d=8, t=64, seed=4)
    spec = PolicySpec("acai", {"h": 16, "k": 4, "batch": 8})
    u = torch.rand((8, 300), generator=torch.Generator().manual_seed(9))
    out = []
    for mesh in (None, host_mesh):
        pol = build_policy(spec, cat, CostModel(c_f=1.0), mesh=mesh, device="cpu")
        out.append((pol.replay(reqs, time_reps=1, uniforms=u), pol.cache.state))
    (ra, sa), (rb, sb) = out
    for k in ("gain", "served_local", "fetched", "occupancy"):
        np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)
    np.testing.assert_allclose(sb.y.numpy(), sa.y.numpy(), rtol=RTOL, atol=1e-6)
    assert torch.equal(sa.x, sb.x)


def test_ivf_sharded_loads_reference_structures(host_mesh):
    """The reference's build_sharded_ivf structures through convert and the
    registry: the sharded step probes them (one ivf_scan call a step on
    the card), keeps y on the capped simplex, and AcaiCache serves
    ivf_sharded on the mesh; the registry builds the sharded backend only
    with a mesh."""
    _, cfg = _cfgs(h=32, k=4)
    cat, reqs, _ = ttrace.sift_like(n=512, d=16, t=64, seed=0)
    jivf = jd.build_sharded_ivf(jnp.asarray(cat), 1, nlist=16, nprobe=8)
    params = {"nlist": 16, "nprobe": 8, "centroids": np.asarray(jivf.centroids),
              "invlists": np.asarray(jivf.invlists)}
    ivf = build_index(IndexSpec("ivf_sharded", params), cat, device="cpu", mesh=host_mesh)
    np.testing.assert_array_equal(ivf.invlists.numpy(), np.asarray(jivf.invlists))
    assert ivf.n_shards == 1 and ivf.nprobe == 8
    with pytest.raises(ValueError, match="needs the device mesh"):
        build_index(IndexSpec("ivf_sharded", params), cat, device="cpu")
    step = D.make_step_sharded(cfg, host_mesh, _t(cat), 8, ivf=ivf)
    st = tpol.init_state(512, cfg, device="cpu")
    for i in range(0, 64, 8):
        st, m = step(st, _t(reqs[i:i + 8]))
    assert abs(float(st.y.sum()) - cfg.h) < 1e-2
    assert bool(torch.isfinite(m.gain_int).all())
    cache = tpol.AcaiCache(cat, dataclasses.replace(cfg, index=IndexSpec(
        "ivf_sharded", {"nlist": 16, "nprobe": 8})), mesh=host_mesh)
    for i in range(0, 32, 8):
        m = cache.serve_update_batch(_t(reqs[i:i + 8]))
    assert cache.index.n_shards == 1
    assert abs(float(cache.state.y.sum()) - cfg.h) < 1e-2
    with pytest.raises(NotImplementedError, match="sharded index backend"):
        cache.add_objects(np.zeros((1, 16), np.float32))
    assert not cache._mutated


def test_convert_state_blocks_round_trip(host_mesh):
    """cache_state_block cuts a whole state into the rank's block and
    gather_state puts it back."""
    rng = np.random.default_rng(0)
    y, x = rng.random(64).astype(np.float32), (rng.random(64) < 0.3).astype(np.float32)
    st = convert.cache_state_block(y, x, host_mesh, t=5)
    assert st.t == 5 and st.y.shape == (64,)
    gy, gx = convert.gather_state(st, host_mesh)
    np.testing.assert_array_equal(gy, y)
    np.testing.assert_array_equal(gx, x)


def test_mesh_guards(host_mesh):
    """What the sharded path refuses, before anything runs."""
    _, cfg = _cfgs(h=16, k=4, a=48)
    cat = _t(np.random.default_rng(0).standard_normal((128, 8)).astype(np.float32))
    euclid = dataclasses.replace(cfg, oma=dataclasses.replace(cfg.oma, mirror="euclidean"))
    with pytest.raises(NotImplementedError, match="negentropy"):
        D.make_step_sharded(euclid, host_mesh, cat, 8)
    ivf2 = D.ShardedIVF(torch.zeros((8, 8)), torch.zeros((8, 4), dtype=torch.int32), 4, 2)
    with pytest.raises(ValueError, match="built for 2 shards"):
        D.make_step_sharded(cfg, host_mesh, cat, 8, ivf=ivf2)
    wide = D.ShardedIVF(torch.zeros((4, 8)), torch.zeros((4, D.IVF_TABLE_MAX // 2 + 1),
                                                         dtype=torch.int32), 4, 2)
    with pytest.raises(ValueError, match=f"table is {D.IVF_TABLE_MAX + 2} slots"):
        D.make_step_sharded(cfg, host_mesh, cat, 8, ivf=wide)
    step = D.make_step_sharded(cfg, host_mesh, cat, 8)
    st = tpol.init_state(128, cfg, device="cpu")
    with pytest.raises(ValueError, match="uniforms"):
        step(st, torch.zeros((8, 8)), torch.zeros(64))
    with pytest.raises(ValueError, match="built for batch 8"):
        step(st, torch.zeros((4, 8)))
    # a tensor's device and its group's backend must agree (CUDA on NCCL):
    # nothing is staged through the host
    from types import SimpleNamespace

    with pytest.raises(ValueError, match="a cuda tensor needs a nccl group"):
        D._group(host_mesh, "model", SimpleNamespace(device=torch.device("cuda")), "x")
    with pytest.raises(NotImplementedError, match="resilient serving on a sharded mesh"):
        tpol.AcaiCache(cat, cfg, mesh=host_mesh, remote=object())
    with pytest.raises(ValueError, match="not the mesh's"):
        tpol.AcaiCache(cat, cfg, mesh=host_mesh, device="meta")
    with pytest.raises(ValueError, match="whole state"):
        tpol.AcaiCache(cat, cfg, mesh=host_mesh, state=tpol.init_state(64, cfg,
                                                                       device="cpu"))


# ---------------------------------------------------------------------------
# spawned worlds: (1, 4), (2, 4), (1, 2)
# ---------------------------------------------------------------------------

RET_N, RET_D, RET_B, RET_C, RET_K, RET_H = 512, 16, 8, 24, 4, 32


@pytest.fixture(scope="module")
def retrieval_data():
    """The reference's retrieval-cell inputs (tests/test_distributed_acai.py)
    and its single-device reference_step on them."""
    rng = np.random.default_rng(0)
    cat = rng.normal(size=(RET_N, RET_D)).astype(np.float32)
    y0 = np.full((RET_N,), RET_H / RET_N, np.float32)
    reqs = rng.normal(size=(RET_B, RET_D)).astype(np.float32)
    kw = dict(d=RET_D, c=RET_C, k=RET_K, c_f=1.0, h=RET_H, eta=0.05, top_a=RET_H + 16)
    y_ref, ans_ref = jd.reference_step(jnp.asarray(cat), jnp.asarray(y0), jnp.asarray(reqs),
                                       c=RET_C, k=RET_K, c_f=1.0, h=RET_H, eta=0.05,
                                       top_a=RET_H + 16)
    ivf = jd.build_sharded_ivf(jnp.asarray(cat), 4, nlist=16, nprobe=8)
    return {"cat": cat, "y0": y0, "reqs": reqs, "kw": kw, "y_ref": np.asarray(y_ref),
            "ans_ref": np.asarray(ans_ref),
            "ivf": (np.asarray(ivf.centroids), np.asarray(ivf.invlists), 16, 8)}


def _budget_data():
    return {"n": 256, "d": 8,
            "cat": np.random.default_rng(0).standard_normal((256, 8)).astype(np.float32)}


def _by_job(ranks):
    return {name: [r[name] for r in ranks] for name in ranks[0]}


@pytest.fixture(scope="module")
def world_1x4(retrieval_data, tmp_path_factory):
    data = {k: retrieval_data[k] for k in ("cat", "y0", "reqs", "kw")}
    return _by_job(run_world(jobs_rank, (1, 4), tmp_path_factory.mktemp("w14"), [
        ("retrieval", data), ("budgets", _budget_data()), ("slab", _slab_case())]))


@pytest.fixture(scope="module")
def world_2x4(retrieval_data, tmp_path_factory):
    data = {k: retrieval_data[k] for k in ("cat", "y0", "reqs", "kw", "ivf")}
    cat, _, _ = ttrace.sift_like(n=RET_N, d=RET_D, t=256, seed=0)
    ivf = jd.build_sharded_ivf(jnp.asarray(cat), 4, nlist=16, nprobe=8)
    replay = {"n": RET_N, "d": RET_D, "t": 256, "h": RET_H, "k": RET_K,
              "ivf": (np.asarray(ivf.centroids), np.asarray(ivf.invlists), 16, 8)}
    return _by_job(run_world(jobs_rank, (2, 4), tmp_path_factory.mktemp("w24"), [
        ("retrieval", data), ("budgets", _budget_data()), ("replay", replay)]))


@pytest.fixture(scope="module")
def world_2x2x2(retrieval_data, tmp_path_factory):
    data = {k: retrieval_data[k] for k in ("cat", "y0", "reqs", "kw")}
    return _by_job(run_world(jobs_rank, (2, 2, 2), tmp_path_factory.mktemp("w222"), [
        ("two_axis", data)]))


def _same_answer_sets(got, want) -> bool:
    return all(set(a.tolist()) == set(b.tolist()) for a, b in zip(got, want))


@pytest.mark.parametrize("shape", ["1x4", "2x4"])
@pytest.mark.parametrize("variant", ["plain", "chunk"])
def test_retrieval_step_matches_reference(request, retrieval_data, shape, variant):
    """make_retrieval_step on (1, 4) and (2, 4) gloo worlds, plain and at
    scan_chunk 50, against the reference's single-device reference_step:
    y within 2e-4, equal answer sets, on every rank."""
    ranks = request.getfixturevalue(f"world_{shape}")["retrieval"]
    for res in ranks:
        r = res[variant]
        assert float(np.abs(r["y"] - retrieval_data["y_ref"]).max()) < 2e-4
        assert _same_answer_sets(r["ans"], retrieval_data["ans_ref"])
        # uniform y = h / N < 0.5: the thresholded cache starts empty
        assert r["gain"] >= 0
    np.testing.assert_array_equal(ranks[0][variant]["y"], ranks[-1][variant]["y"])


def test_retrieval_on_the_references_sharded_ivf(world_2x4):
    """Each rank probes only its own lists (the reference's structures,
    loaded through convert): y stays on the capped simplex, the answers
    are real catalog ids."""
    for res in world_2x4["retrieval"]:
        r = res["ivf"]
        assert abs(float(r["y"].sum()) - RET_H) < 1e-2
        assert ((r["y"] >= 0) & (r["y"] <= 1)).all()
        assert ((r["ans"] >= 0) & (r["ans"] < RET_N)).all()
        assert r["gain"] >= 0


def test_sharded_replay_nag_close_to_batched(world_2x4):
    """make_replay_sharded on (2, 4) reaches the single-device batched
    replay's quality (the reference's limit, 0.95 of its NAG); metrics
    cover the whole batch on every rank; the serving step on the sharded
    IVF keeps y on the simplex."""
    for r in world_2x4["replay"]:
        assert r["metrics_shape"] == (256,)
        assert r["nag_sharded"] > 0.95 * r["nag_batched"] and r["nag_sharded"] > 0
        assert abs(r["ivf_y_sum"] - RET_H) < 1e-2 and r["ivf_gain_finite"]
    assert len({r["nag_sharded"] for r in world_2x4["replay"]}) == 1


@pytest.mark.parametrize("variant", ["plain", "chunk"])
def test_retrieval_step_over_two_batch_axes_matches_reference(world_2x2x2, retrieval_data,
                                                              variant):
    """The batch over ("pod", "data") on a (pod 2, data 2, model 2) gloo
    world (ROADMAP C9: the exchange once raised NotImplementedError for two
    batch axes of more than one rank): make_retrieval_step against the
    reference's single-device reference_step, y within 2e-4 and equal
    answer sets on every rank; the routing gather and each metric's
    all-reduce run once an axis (sites route 2, metrics 4)."""
    ranks = world_2x2x2["two_axis"]
    for res in ranks:
        r = res[variant]
        assert float(np.abs(r["y"] - retrieval_data["y_ref"]).max()) < 2e-4
        assert _same_answer_sets(r["ans"], retrieval_data["ans_ref"])
        assert r["sites"]["all_gather:route"] == 2
        assert r["sites"]["all_reduce:metrics"] == 4
        assert r["sites"]["all_gather:merge"] == 1
    assert len({(r[variant]["gain"], r[variant]["local"]) for r in ranks}) == 1


@pytest.mark.parametrize("kind", ["step", "mutable"])
def test_sharded_steps_over_two_batch_axes_match_single_device(world_2x2x2, kind):
    """make_step_sharded and make_mutable_step_sharded with the batch over
    ("pod", "data") on (2, 2, 2): the whole batch's metrics come back in
    request order and equal the single-device step's (1e-5), and so does
    y (the same uniforms)."""
    for res in world_2x2x2["two_axis"]:
        r = res[kind]
        for f in ("gain_int", "gain_frac", "cost", "served_local"):
            want, got = r[f]
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=f)
        np.testing.assert_allclose(r["y"], r["y_ref"], rtol=1e-5, atol=1e-6)
    counts = world_2x2x2["two_axis"][0]["step"]["counts"]
    assert counts == {"all_gather": 4, "all_reduce": 1}


@pytest.mark.parametrize("shape,path,want", [
    ("1x4", "exact", {"all_gather": 2, "all_reduce": 1}),
    ("1x4", "mutable", {"all_gather": 2, "all_reduce": 1}),
    ("2x4", "exact", {"all_gather": 3, "all_reduce": 1}),
    ("2x4", "wide", {"all_gather": 3, "all_reduce": 1}),
    ("2x4", "ivf", {"all_gather": 4, "all_reduce": 1}),
    ("2x4", "chunk", {"all_gather": 4, "all_reduce": 1}),
    ("2x4", "mutable", {"all_gather": 3, "all_reduce": 1}),
    ("2x4", "retrieval", {"all_gather": 3, "all_reduce": 2}),
])
def test_collective_budgets(request, shape, path, want):
    """The collectives a step, pinned as tests/test_collectives.py pins the
    reference's, plus the port's rounding reduction: (1, P) exact 2 + 1, a
    data axis one routing gather more, the IVF and scan_chunk paths one
    merge gather more, the mutable step the static one's, the retrieval
    cell its two metric reductions; wider candidate slabs cost nothing."""
    for res in request.getfixturevalue(f"world_{shape}")["budgets"]:
        total, counts = res[path]
        assert counts == want and total == sum(want.values())


def _slab_case():
    rng = np.random.default_rng(0)
    return {"vecs": rng.standard_normal((70, 8)).astype(np.float32),
            "emb": rng.standard_normal((128, 8)).astype(np.float32),
            "valid": np.arange(128) < 100, "n_slots": 100}


def _reference_slab(case, p):
    emb, valid, ids = jd.sharded_slab_append(jnp.asarray(case["emb"]),
                                             jnp.asarray(case["valid"]), case["n_slots"],
                                             case["vecs"], p)
    return np.asarray(emb), np.asarray(valid), ids


def test_sharded_slab_append_four_ranks_matches_reference(world_1x4):
    """sharded_slab_append over four ranks, gathered, against the
    reference's at P = 4: the straddling batch split at block boundaries,
    the grown capacity, the carried rows moved to their new owners."""
    case = _slab_case()
    emb, valid, ids = _reference_slab(case, 4)
    for r in world_1x4["slab"]:
        np.testing.assert_array_equal(r["emb"], emb)
        np.testing.assert_array_equal(r["valid"], valid)
        np.testing.assert_array_equal(r["ids"], ids)
        y = np.zeros(emb.shape[0], np.float32)
        y[:128] = np.arange(128)
        np.testing.assert_array_equal(r["y"], y)
        assert r["sites"].get(("all_gather", "regrid")) == 1


@pytest.fixture(scope="module")
def world_1x2_serving(tmp_path_factory):
    runs = {"exact": [], "ivf_sharded": ["--remote-index", "ivf_sharded", "--index-opt",
                                         "nlist=4", "--index-opt", "nprobe=2"],
            "churn": ["--churn-rate", "0.5"]}
    return run_world(serving_rank, (1, 2), tmp_path_factory.mktemp("w12"),
                     {"launcher_runs": runs})


def test_semantic_cached_lm_on_two_ranks(world_1x2_serving):
    """SemanticCachedLM(mesh=) over two ranks serves every prompt, with the
    same metrics on both ranks and the single-device tier's quality."""
    a, b = world_1x2_serving
    np.testing.assert_array_equal(a["mesh_served"], b["mesh_served"])
    assert a["nags"]["mesh"] == b["nags"]["mesh"]
    assert a["mesh_requests"] == a["single_requests"] == 33
    assert abs(a["nags"]["mesh"] - a["nags"]["single"]) < 0.02
    assert 0.0 <= a["nags"]["mesh"] <= 1.0


def test_launcher_mesh_shards_on_two_ranks(world_1x2_serving):
    """`--mesh-shards 2 --smoke --device cpu` in a two-rank world: exact, on
    ivf_sharded and under churn; the ranks agree and only rank 0 prints."""
    a, b = world_1x2_serving
    assert a["launcher"] == b["launcher"]
    for label, fig in a["launcher"].items():
        assert fig["shards"] == 2 and fig["requests"] == 12, label
        assert 0.0 <= fig["nag"] <= 1.0, label
    assert a["launcher"]["churn"]["churn_events"] > 0
    assert a["launcher"]["ivf_sharded"]["index"]["backend"] == "ivf_sharded"
    assert "semantic cache" in a["printed"] and b["printed"] == ""


@pytest.mark.parametrize("flags,msg", [
    (["--mesh-shards", "2"], "torchrun --nproc-per-node 2"),
    (["--mesh-shards", "2", "--policy", "lru"], "sequential baseline"),
    (["--remote-index", "ivf_sharded"], "sharded backend"),
    (["--mesh-shards", "2", "--remote-index", "flat"], "single-device; with --mesh-shards"),
    (["--mesh-shards", "2", "--remote-index", "ivf_sharded", "--churn-rate", "0.1"],
     "exact masked scan"),
    (["--mesh-shards", "2", "--answer-cache", "8", "--remote-index", "ivf_sharded"],
     "single-device cache"),
    (["--mesh-shards", "2", "--remote-fault-rate", "0.1"], "resilient serving path"),
    (["--mesh-shards", "3"], "--catalog must divide"),
])
def test_launcher_mesh_validation_errors(flags, msg):
    """The reference's --mesh-shards validation, raised before any world is
    joined or model built; outside a world of P ranks the launcher exits
    naming torchrun."""
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match=msg):
        serve.main(["--smoke", "--device", "cpu", "--requests", "4", "--catalog", "64",
                    *flags])
