"""Port parity of the policy API: `repro_torch.core.policy_api` against
`repro.core.policy_api` (CachePolicy conformance across every registered
policy, PolicySpec round trips, the registry, batched baselines against
the sequential path, the augmented serving rule, AÇAI through the
registry).

The baselines run on an oracle holding the reference oracle's answers, so
their decisions must be the reference's; AÇAI runs from the reference's
initial state with its rounding uniforms injected (drawn as
tests/test_torch_policy.py draws them).  Tolerances: gains to rtol 1e-5,
atol 1e-5 x k c_f; served_local, fetched and occupancy equal.  The
reference's `test_dryrun_records_policy_spec` waits for the dry-run
tooling (ROADMAP A12).
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JB
from repro.core import policy_api as JPA
from repro.core import trace as jtrace
from repro.core.costs import CostModel as JCostModel
from repro.core.costs import calibrate_fetch_cost as j_calibrate
from repro_torch import convert
from repro_torch.core import baselines as B
from repro_torch.core import oma, policy, trace
from repro_torch.core import policy_api as PA
from repro_torch.core.costs import CostModel, calibrate_fetch_cost
from repro_torch.core.policy_api import (PolicySpec, build_policy, parse_policy_opts,
                                         registered_policies)
from repro_torch.core.policy_api import TINY_POLICY_KWARGS as TINY
from repro_torch.core.trace import TINY_TRACE_KWARGS

BENCH = pathlib.Path(__file__).resolve().parent.parent / "BENCH_experiments.json"


def reference_uniforms(key, n: int, steps: int) -> np.ndarray:
    """(steps, n) rounding uniforms, as the reference draws them: key,
    k_round = split(key) per step, uniform(k_round, (n,))."""
    out = np.empty((steps, n), np.float32)
    for i in range(steps):
        key, k_round = jax.random.split(key)
        out[i] = np.asarray(jax.random.uniform(k_round, (n,), dtype=jnp.float32))
    return out


def shared_oracles(catalog, reqs, kmax=16):
    """(reference oracle, port oracle holding the reference's answers)."""
    jo = JB.ServerOracle(catalog, reqs, kmax=kmax)
    to = B.ServerOracle(catalog, reqs, kmax=kmax, device="cpu")
    to.ids, to.d2 = jo.ids.copy(), jo.d2.copy()
    return jo, to


def from_reference_state(pol, jpol, steps: int):
    """Start the port's AÇAI policy from the reference's state; returns
    the reference's uniforms of the next `steps` steps."""
    st = jpol.cache.state
    pol.cache.state = convert.cache_state_from_numpy(np.asarray(st.y), np.asarray(st.x),
                                                     int(st.t), device="cpu")
    return reference_uniforms(st.key, st.y.shape[0], steps)


@pytest.fixture(scope="module")
def setup():
    catalog, reqs, _ = trace.sift_like(n=400, d=16, t=96, seed=0)
    jo, to = shared_oracles(catalog, reqs)
    return catalog, reqs, CostModel(c_f=1.0), to, jo


def _build(name, kw, catalog, cm, oracle, **extra):
    return build_policy(PolicySpec(name, kw), catalog, cm, oracle=oracle, seed=0,
                        device="cpu", **extra)


# ---------------------------------------------------------------------------
# batched step-contract conformance (all policies, one shared test)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TINY))
def test_step_contract(setup, name):
    """Every per-request field comes back (B,); AÇAI's step leaves the
    resilience and answer-tier counters at their int 0 default (those
    tiers are not ported).  The first batch equals the reference's."""
    catalog, reqs, cm, oracle, jo = setup
    pol = _build(name, TINY[name], catalog, cm, oracle)
    jpol = JPA.build_policy(JPA.PolicySpec(name, TINY[name]), catalog,
                            JCostModel(c_f=1.0), oracle=jo, seed=0)
    assert isinstance(pol, PA.CachePolicy)
    assert pol.spec.name == name
    assert pol.k == 4 and pol.c_f == 1.0 and pol.h == 16
    u = from_reference_state(pol, jpol, 1)[0] if name == "acai" else None
    m = (pol.serve_update_batch(reqs[:8], np.arange(8), u=torch.from_numpy(u))
         if name == "acai" else pol.serve_update_batch(reqs[:8], np.arange(8)))
    jm = jpol.serve_update_batch(reqs[:8], np.arange(8))
    for field in policy.StepMetrics._fields:
        a = np.asarray(getattr(m, field))
        assert a.shape == (8,) or (name == "acai" and a.shape == () and a == 0), (name, field)
    np.testing.assert_array_equal(np.asarray(m.served_local), np.asarray(jm.served_local))
    np.testing.assert_allclose(np.asarray(m.gain_int), np.asarray(jm.gain_int),
                               rtol=1e-5, atol=1e-5 * 4)
    assert np.isfinite(np.asarray(m.gain_int)).all()
    assert (np.asarray(m.cost) >= -1e-5).all()
    assert (np.asarray(m.served_local) <= pol.k).all()
    m1 = pol.serve_update(reqs[8], 8)  # B = 1 view
    assert np.asarray(m1.gain_int).shape == ()
    assert int(np.asarray(m1.answer_hits)) == 0
    nag = pol.normalized_gain(float(np.sum(np.asarray(m.gain_int))), 8)
    assert np.isfinite(nag)


@pytest.mark.parametrize("name", sorted(TINY))
def test_occupancy_invariant(setup, name):
    """Occupancy never exceeds h (AÇAI's tiny spec pins depround), and it
    follows the reference's step for step."""
    catalog, reqs, cm, oracle, jo = setup
    pol = _build(name, TINY[name], catalog, cm, oracle)
    jpol = JPA.build_policy(JPA.PolicySpec(name, TINY[name]), catalog,
                            JCostModel(c_f=1.0), oracle=jo, seed=0)
    us = from_reference_state(pol, jpol, 12) if name == "acai" else None
    for i, s in enumerate(range(0, 96, 8)):
        ts = np.arange(s, s + 8)
        m = (pol.serve_update_batch(reqs[s:s + 8], ts, u=torch.from_numpy(us[i]))
             if us is not None else pol.serve_update_batch(reqs[s:s + 8], ts))
        jm = jpol.serve_update_batch(reqs[s:s + 8], ts)
        assert (np.asarray(m.occupancy) <= pol.h + 1e-6).all(), name
        np.testing.assert_array_equal(np.asarray(m.occupancy), np.asarray(jm.occupancy))


@pytest.mark.parametrize("name", sorted(set(TINY) - {"acai"}))
def test_augmented_cost_never_worse(setup, name):
    """The augmented serving rule can only lower the serving cost: the hit
    logic (hence the trajectory) is unchanged, and the augmented answer
    picks the cheapest copy per object from a superset of options.  Both
    replays equal the reference's."""
    catalog, reqs, cm, oracle, jo = setup
    ts = np.arange(96)
    out = {}
    for aug in (False, True):
        kw = {**TINY[name], **({"augmented": True} if aug else {})}
        out[aug] = PA.replay_trace(_build(name, kw, catalog, cm, oracle), reqs, ts, batch=8)
        ref = JPA.replay_trace(JPA.build_policy(JPA.PolicySpec(name, kw), catalog,
                                                JCostModel(c_f=1.0), oracle=jo, seed=0),
                               reqs, ts, batch=8)
        np.testing.assert_array_equal(out[aug]["served_local"], ref["served_local"])
        np.testing.assert_allclose(out[aug]["gain"], ref["gain"], rtol=1e-5, atol=4e-5)
    m_p, m_a = out[False], out[True]
    assert (m_a["cost"] <= m_p["cost"] + 1e-6).all(), name
    assert m_a["gain"].sum() >= m_p["gain"].sum() - 1e-6


def test_lru_exact_hit_semantics(setup):
    """LRU hits iff the request is byte-identical to a cached key."""
    catalog, reqs, cm, oracle, _ = setup
    pol = _build("lru", TINY["lru"], catalog, cm, oracle)
    m = pol.serve_update(reqs[0], 0)
    assert not bool(np.asarray(m.served_local) > 0)  # cold miss
    m = pol.serve_update(reqs[0], 0)                 # identical request
    assert bool(np.asarray(m.served_local) > 0)
    other = np.nextafter(reqs[1], np.inf).astype(np.float32)
    m = pol.serve_update(other, 1)
    assert not bool(np.asarray(m.served_local) > 0)


def test_batched_matches_sequential(setup):
    """step_batch (vectorized hit tests + serving costs) takes the same hit
    decisions as the sequential per-step path."""
    catalog, reqs, cm, oracle, _ = setup
    for name in ("SIM-LRU", "QCACHE", "CLS-LRU"):
        kw = dict(h=24, k=4, c_f=1.0, seed=0)
        if name != "QCACHE":
            kw.update(k_prime=8, c_theta=1.5)
        m_seq = B.run_policy(B.POLICIES[name](catalog, oracle, **kw), reqs)
        bat = B.POLICIES[name](catalog, oracle, **kw)
        res = []
        for s in range(0, 96, 16):
            res.extend(bat.step_batch(np.arange(s, s + 16), reqs[s:s + 16]))
        np.testing.assert_array_equal(np.array([r.hit for r in res]), m_seq["hit"],
                                      err_msg=name)
        np.testing.assert_allclose(np.array([r.gain for r in res]), m_seq["gain"],
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_oracle_fused_precompute_and_online(setup):
    """The oracle returns exact kNN (against brute force in float64), the
    online extend() path matches the precomputed table, and a small chunk
    scans exactly."""
    catalog, reqs, _, _, _ = setup
    oracle = B.ServerOracle(catalog, reqs[:16], kmax=8, device="cpu")
    q = reqs[:4].astype(np.float64)
    d2 = ((q[:, None, :] - catalog[None].astype(np.float64)) ** 2).sum(-1)
    for b in range(4):
        np.testing.assert_allclose(np.sort(d2[b])[:8], oracle.d2[b], rtol=1e-4, atol=1e-4)
    online = B.ServerOracle(catalog, kmax=8, device="cpu")
    ts = online.extend(reqs[:16])
    assert list(ts) == list(range(16))
    np.testing.assert_allclose(online.d2, oracle.d2, rtol=1e-5, atol=1e-5)
    tiny = B.ServerOracle(catalog, reqs[:16], kmax=8, chunk=64, device="cpu")
    np.testing.assert_allclose(tiny.d2, oracle.d2, rtol=1e-6, atol=1e-6)
    # a baseline built without an oracle answers online, one scan a batch
    pol = _build("sim_lru", TINY["sim_lru"], catalog, CostModel(c_f=1.0), None)
    assert pol.oracle.kmax == 16 and not pol.oracle.retain_all
    on = PA.replay_trace(pol, reqs, None, batch=8)
    pre = PA.replay_trace(_build("sim_lru", TINY["sim_lru"], catalog, CostModel(c_f=1.0),
                                 B.ServerOracle(catalog, reqs, kmax=16, device="cpu")),
                          reqs, np.arange(96), batch=8)
    np.testing.assert_array_equal(on["served_local"], pre["served_local"])
    np.testing.assert_allclose(on["gain"], pre["gain"], rtol=1e-6, atol=1e-6)


def test_acai_replay_b1_bit_consistent(setup):
    """AcaiPolicy.replay at batch 1 is the per-request replay, bit for bit
    (same initial state, same uniforms), and its timing leaves the state
    where the replay starts."""
    catalog, reqs, _, _, _ = setup
    c_f = calibrate_fetch_cost(catalog, kth=50, sample=128, device="cpu")
    cfg = policy.AcaiConfig(h=24, k=4, c_f=c_f, c_remote=16, c_local=8,
                            oma=oma.OMAConfig(eta=0.05 / c_f))
    fn = policy.exact_candidate_fn_batched(torch.from_numpy(catalog), 16, 8)
    state0 = policy.init_state(400, cfg, seed=0, device="cpu")
    us = torch.rand(96, 400, generator=torch.Generator().manual_seed(3))
    _, m = policy.make_replay(cfg, fn)(policy.copy_state(state0), torch.from_numpy(reqs), us)
    spec = PolicySpec("acai", {"h": 24, "k": 4, "c_remote": 16, "c_local": 8,
                               "eta": 0.05 / c_f, "batch": 1})
    pol = build_policy(spec, catalog, CostModel(c_f=c_f), seed=0, device="cpu")
    pol.cache.state = policy.copy_state(state0)
    res = pol.replay(reqs, uniforms=us)
    np.testing.assert_array_equal(res["gain"], m.gain_int.double().numpy())
    np.testing.assert_array_equal(res["cost"], m.cost.double().numpy())
    np.testing.assert_array_equal(res["served_local"], m.served_local.numpy())
    assert pol.cache.state.t == 96 and res["requests"] == 96 and res["p50_step_s"] > 0


# ---------------------------------------------------------------------------
# PolicySpec serialization + registry + CLI parsing
# ---------------------------------------------------------------------------

def test_spec_roundtrip():
    spec = PolicySpec("sim_lru", {"h": 200, "k_prime": 20, "c_theta": 1.5,
                                  "augmented": True})
    d = spec.to_dict()
    assert d == {"policy": "sim_lru", "h": 200, "k_prime": 20, "c_theta": 1.5,
                 "augmented": True}
    assert PolicySpec.from_dict(d) == spec
    assert spec.with_params(k_prime=40).params["k_prime"] == 40
    assert hash(spec) == hash(PolicySpec("sim_lru", dict(reversed(
        list(spec.params.items())))))
    assert spec.label.startswith("sim_lru(")
    assert spec.label == JPA.PolicySpec("sim_lru", spec.params).label


def test_spec_errors(setup):
    catalog, _, cm, _, _ = setup
    with pytest.raises(ValueError, match="unknown policy"):
        PolicySpec.from_dict({"policy": "fifo"})
    with pytest.raises(ValueError, match="unknown policy"):
        build_policy("fifo", catalog, cm, device="cpu")
    with pytest.raises(ValueError, match="policy"):
        PolicySpec.from_dict({"h": 8})
    with pytest.raises(ValueError, match="spec field"):
        PolicySpec("acai", {"policy": "acai"})
    with pytest.raises(ValueError, match="needs 'h'"):
        build_policy(PolicySpec("acai", {"k": 4}), catalog, cm, device="cpu")
    with pytest.raises(ValueError, match="unknown acai policy params"):
        build_policy(PolicySpec("acai", {"h": 8, "nlist": 4}), catalog, cm, device="cpu")
    with pytest.raises(ValueError, match="index_spec"):
        build_policy(PolicySpec("lru", {"h": 8}), catalog, cm, index_spec="flat",
                     device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        build_policy(PolicySpec("qcache", {"h": 8}), catalog, cm, mesh=object(),
                     device="cpu")
    # what is not ported yet names its ROADMAP item
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        build_policy(PolicySpec("acai", {"h": 8}), catalog, cm, mesh=object(), device="cpu")
    # the answer tier (ported) fronts an index: without one it is refused,
    # as in the reference (tests/test_torch_answer_cache.py holds the rest)
    with pytest.raises(ValueError, match="cfg.index"):
        build_policy(PolicySpec("acai", {"h": 8}), catalog, cm, answer_cache=8,
                     device="cpu")
    assert build_policy(PolicySpec("acai", {"h": 8}), catalog, cm, answer_cache=8,
                        index_spec="flat", device="cpu").answer_cache is not None
    pol = build_policy(PolicySpec("acai", {"h": 8}), catalog, cm, device="cpu")
    # AÇAI's catalog mutates online (tests/test_torch_mutable.py)
    assert pol.add_objects(catalog[:1]).tolist() == [catalog.shape[0]]
    assert pol.live_count == catalog.shape[0] + 1
    # the online engine is ported (tests/test_torch_serving_engine.py)
    res = PA.replay_trace_online(pol, catalog[:8], np.zeros(8))
    assert res["requests"] == res["served"] == 8


def test_resolve_policy_spec():
    assert PA.resolve_policy_spec(None) is None
    spec = PolicySpec("acai", {"h": 8})
    assert PA.resolve_policy_spec(spec) is spec
    assert PA.resolve_policy_spec("qcache") == PolicySpec("qcache")
    assert PA.resolve_policy_spec({"policy": "acai", "h": 8}) == spec
    with pytest.raises(ValueError, match="unknown policy"):
        PA.resolve_policy_spec("fifo")
    with pytest.raises(TypeError):
        PA.resolve_policy_spec(42)


def test_parse_policy_opts():
    opts = ["k_prime=20", "c_theta=1.5", "augmented=true", "mirror=negentropy",
            "round_every=1"]
    assert parse_policy_opts(opts) == JPA.parse_policy_opts(opts) == {
        "k_prime": 20, "c_theta": 1.5, "augmented": True, "mirror": "negentropy",
        "round_every": 1}
    assert parse_policy_opts([]) == {}
    assert parse_policy_opts(None) == {}
    with pytest.raises(ValueError, match="key=value"):
        parse_policy_opts(["augmented"])


def test_registry_complete():
    """The six paper policies are registered, as in the reference; the
    tiny tables cover every registered policy and trace scenario."""
    assert set(registered_policies()) == set(JPA.registered_policies()) == {
        "acai", "lru", "sim_lru", "cls_lru", "rnd_lru", "qcache"}
    assert TINY == JPA.TINY_POLICY_KWARGS
    assert set(TINY_TRACE_KWARGS) == set(trace.registered_traces())
    for name, key in PA._BASELINE_CLASS.items():
        assert key in B.POLICIES, name


def test_spec_roundtrip_property():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    keys = st.text("abcdefgh_", min_size=1, max_size=8).filter(lambda s: s != "policy")
    vals = st.one_of(st.integers(-1000, 1000),
                     st.floats(-100, 100, allow_nan=False, width=32),
                     st.booleans(), st.text("xyz01", max_size=6))

    @settings(max_examples=60, deadline=None)
    @given(name=st.sampled_from(sorted(registered_policies())),
           params=st.dictionaries(keys, vals, max_size=6))
    def check(name, params):
        spec = PolicySpec(name, params)
        d = spec.to_dict()
        assert PolicySpec.from_dict(d) == spec
        assert PolicySpec.from_dict(dict(d)) == spec
        assert d["policy"] == name
        assert spec.with_params(**params) == spec
        assert spec.label == JPA.PolicySpec(name, params).label

    check()


def test_spec_label_matches_reference_for_bench_rows():
    """The row names of BENCH_experiments.json: the port's label of each of
    the 24 policy dicts is the reference's string."""
    rows = json.loads(BENCH.read_text())["rows"]
    assert len(rows) == 24
    for r in rows:
        assert PolicySpec.from_dict(r["policy"]).label == r["label"] == \
            JPA.PolicySpec.from_dict(r["policy"]).label


# ---------------------------------------------------------------------------
# AÇAI through the registry against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [TINY["acai"],
                                {"h": 24, "k": 4, "c_remote": 16, "c_local": 8, "batch": 8}])
def test_acai_policy_matches_reference_with_injected_uniforms(setup, kw):
    """build_policy("acai") replayed from the reference's state with its
    uniforms equals the reference's AcaiPolicy.replay."""
    catalog, reqs, _, _, _ = setup
    c_f = 0.7
    spec = {**kw, "c_f": c_f}
    jpol = JPA.build_policy(JPA.PolicySpec("acai", spec), catalog, None, seed=0)
    pol = build_policy(PolicySpec("acai", spec), catalog, None, seed=0, device="cpu")
    us = from_reference_state(pol, jpol, 96 // 8)
    want = jpol.replay(reqs)
    got = pol.replay(reqs, uniforms=us)
    assert got["requests"] == want["requests"] == 96
    np.testing.assert_allclose(got["gain"], want["gain"], rtol=1e-5, atol=1e-5 * 4 * c_f)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-5, atol=1e-5 * 4 * c_f)
    for field in ("served_local", "fetched", "occupancy", "hit"):
        np.testing.assert_array_equal(got[field], want[field], err_msg=field)
    np.testing.assert_array_equal(pol.cache.state.x.numpy(), np.asarray(jpol.cache.state.x))


def test_acai_cache_policy_spec_form_equals_config_form(setup):
    catalog, reqs, _, _, _ = setup
    cfg = policy.AcaiConfig(h=24, k=4, c_f=0.7, c_remote=16, c_local=8,
                            oma=oma.OMAConfig(eta=0.05 / 0.7))
    spec = PolicySpec("acai", {"h": 24, "k": 4, "c_remote": 16, "c_local": 8})
    forms = [policy.AcaiCache(catalog, spec, c_f=0.7, device="cpu"),
             policy.AcaiCache(catalog, spec.to_dict(), c_f=0.7, device="cpu"),
             policy.AcaiCache(catalog, spec.with_params(c_f=0.7), device="cpu")]
    direct = policy.AcaiCache(catalog, cfg, device="cpu")
    for cache in forms:
        assert cache.cfg == direct.cfg
        cache.state = policy.copy_state(direct.state)
    u = torch.rand(400, generator=torch.Generator().manual_seed(1))
    want = direct.serve_update_batch(reqs[:8], u)
    for cache in forms:
        got = cache.serve_update_batch(reqs[:8], u)
        assert all(torch.equal(a, b) for a, b in zip(got[:6], want[:6]))
    with pytest.raises(ValueError, match="needs 'h'"):
        policy.AcaiCache(catalog, "acai", c_f=0.7, device="cpu")
    with pytest.raises(ValueError, match="build_policy"):
        policy.AcaiCache(catalog, "sim_lru", c_f=0.7, device="cpu")
    with pytest.raises(ValueError, match="c_f= only applies"):
        policy.AcaiCache(catalog, cfg, c_f=0.7, device="cpu")
    with pytest.raises(ValueError, match="needs a cost model"):
        policy.AcaiCache(catalog, spec, device="cpu")
    # the escape hatches: a batched generator (bitwise the built-in one)
    # and a per-request one (its B = 1 products may differ in the last bit)
    fn = policy.exact_candidate_fn_batched(torch.from_numpy(catalog), 16, 8)
    for hatch, exact in (({"candidate_fn_batched": fn}, True),
                         ({"candidate_fn": lambda r, x: tuple(t[0] for t in fn(r[None], x))},
                          False)):
        caches = [policy.AcaiCache(catalog, cfg, device="cpu", **hatch),
                  policy.AcaiCache(catalog, cfg, device="cpu")]
        for cache in caches:
            cache.state = policy.copy_state(direct.state)
            cache.serve_update_batch(reqs[:8], u)
        got, want = (c.serve_update_batch(reqs[8:16], u) for c in caches)
        if exact:
            assert torch.equal(got.gain_int, want.gain_int)
        torch.testing.assert_close(got.gain_int, want.gain_int, rtol=1e-5, atol=1e-5 * 4 * 0.7)
        assert torch.equal(got.served_local, want.served_local)
    with pytest.warns(DeprecationWarning):
        policy.AcaiCache(catalog, policy.AcaiConfig(h=8, index="flat"), device="cpu",
                         candidate_fn_batched=fn)


def test_paper_ordering_on_tiny_stationary_trace():
    """The paper's qualitative claim at conformance scale: AÇAI's NAG is at
    least every baseline's on the stationary sift-like trace (c_f as the
    reference calibrates it, AÇAI from the reference's state and
    uniforms, the baselines on the reference oracle's answers)."""
    catalog, reqs, _ = jtrace.sift_like(n=400, d=16, t=512, seed=0)
    c_f = float(j_calibrate(jnp.asarray(catalog), kth=50, sample=128))
    cm = CostModel(c_f=c_f)
    jo, oracle = shared_oracles(catalog, reqs)
    ts = np.arange(reqs.shape[0])
    nags = {}
    for name, kw in TINY.items():
        kw = {**kw, "h": 40}
        if name in ("sim_lru", "cls_lru", "rnd_lru"):
            kw["c_theta"] = 1.5 * c_f
        pol = _build(name, kw, catalog, cm, oracle)
        replay_kw = {}
        if name == "acai":
            jpol = JPA.build_policy(JPA.PolicySpec(name, kw), catalog, JCostModel(c_f=c_f),
                                    seed=0)
            replay_kw["uniforms"] = from_reference_state(pol, jpol, 512 // 8)
        res = PA.replay_trace(pol, reqs, ts, batch=8, **replay_kw)
        nags[name] = pol.normalized_gain(res["gain"].sum(), res["requests"])
    for name, v in nags.items():
        assert nags["acai"] >= v - 1e-9, (name, nags)
