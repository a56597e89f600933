"""Port parity, the resilient serving tier: repro_torch.serve.remote /
resilience and train.fault.StragglerMonitor against the reference's, on
the CPU.

Held exactly (the host code on the virtual clock is ported line for
line): FaultyRemote outcomes, backoffs, simulate_request's reports, the
breaker's decision log, the session counters and latency percentiles,
the straggler flags.  The degraded serve and `make_degraded_step` (fed
the reference's `k_round` uniforms) to 1e-6, with the served / shed /
degraded flags and x exact.  Resilient replays of every registered
policy: counters and breaker logs exactly, gains within 1e-5 (AÇAI with
the reference's uniforms injected).  The fault-rate-0 pin against the
plain replay is the port's own and bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JB
from repro.core import policy as jpolicy
from repro.core import policy_api as JPA
from repro.core import trace as jtrace
from repro.core.costs import CostModel as JCostModel
from repro.serve import remote as JR
from repro.serve import resilience as JRes
from repro.train.fault import StragglerMonitor as JStraggler
from repro_torch import convert
from repro_torch.core import baselines as B
from repro_torch.core import policy
from repro_torch.core import policy_api as PA
from repro_torch.core.costs import CostModel
from repro_torch.core.policy_api import TINY_POLICY_KWARGS as TINY
from repro_torch.serve import remote as R
from repro_torch.serve import resilience as Res
from repro_torch.serve.remote import FaultSpec, FaultyRemote, OracleRemote, payload_ok
from repro_torch.serve.resilience import (BreakerConfig, CircuitBreaker,
                                          ResilienceConfig, ResilientPolicy,
                                          RetryConfig, replay_resilient,
                                          simulate_request)
from repro_torch.train.fault import StragglerMonitor

TOL = 1e-6


def reference_uniforms(key, n: int, steps: int) -> np.ndarray:
    out = np.empty((steps, n), np.float32)
    for i in range(steps):
        key, k_round = jax.random.split(key)
        out[i] = np.asarray(jax.random.uniform(k_round, (n,), dtype=jnp.float32))
    return out


@pytest.fixture(scope="module")
def setup():
    catalog, reqs, _ = jtrace.sift_like(n=400, d=16, t=96, seed=0)
    return np.asarray(catalog), np.asarray(reqs), CostModel(c_f=1.0)


FAULTS = [
    dict(error_rate=0.3, corrupt_rate=0.1, latency_sigma=0.4, seed=7),
    dict(error_rate=0.2, latency_ms=40.0, latency_sigma=0.8, seed=3),
    dict(spike_every=10, spike_width=2, spike_ms=300.0, seed=1),
    dict(error_rate=0.5, outages=((10, 30),), error_latency_ms=25.0, seed=2),
    dict(),
]


def _pair_remote(kw):
    return FaultyRemote(FaultSpec(**kw)), JR.FaultyRemote(JR.FaultSpec(**kw))


# ---------------------------------------------------------------------------
# the fault schedule: the reference's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", FAULTS)
def test_fault_outcomes_equal_reference(kw):
    port, ref = _pair_remote(kw)
    for t in range(64):
        for a in (0, 1, 2, Res.HEDGE_ATTEMPT_OFFSET):
            assert tuple(port.outcome(t, a)) == tuple(ref.outcome(t, a)), (t, a)
    assert FaultSpec(**kw).to_dict() == JR.FaultSpec(**kw).to_dict()
    assert FaultSpec.from_dict(FaultSpec(**kw).to_dict()) == FaultSpec(**kw)
    assert FaultSpec(**kw).is_null == JR.FaultSpec(**kw).is_null


def test_schedule_order_independent_and_null_spec():
    spec = FaultSpec(error_rate=0.3, corrupt_rate=0.1, latency_sigma=0.4, seed=7)
    a, b = FaultyRemote(spec), FaultyRemote(spec)
    fwd = [a.outcome(t) for t in range(32)]
    assert fwd == [b.outcome(t) for t in reversed(range(32))][::-1]
    assert len({a.outcome(5, attempt=i) for i in range(16)}) > 1
    assert FaultSpec().is_null
    r = FaultyRemote(FaultSpec())
    assert all(r.outcome(t, i).ok for t in range(64) for i in range(3))


def test_outage_windows_and_parsing():
    spec = FaultSpec(outages=((10, 20),))
    r = FaultyRemote(spec)
    assert spec.in_outage(10) and spec.in_outage(19) and not spec.in_outage(20)
    assert r.outcome(15, attempt=5).kind == "outage"
    with pytest.raises(ConnectionError):
        r.fetch(np.zeros((1, 4), np.float32), 2, t=15)
    for specs in (["10:20", "40:50"], ["0:1"]):
        assert R.parse_outage_windows(specs) == JR.parse_outage_windows(specs)
    for bad in (["20:10"], ["nope"], ["3:3"]):
        with pytest.raises(ValueError):
            R.parse_outage_windows(bad)
    for kw in ({"error_rate": 1.5}, {"corrupt_rate": -0.1}, {"outages": ((5, 2),)}):
        with pytest.raises(ValueError):
            FaultSpec(**kw)


def test_corrupt_payload_detected_never_consumed(setup):
    catalog, reqs, _ = setup
    oracle = B.ServerOracle(catalog, kmax=8, device="cpu")
    joracle = JB.ServerOracle(catalog, kmax=8)
    r = FaultyRemote(FaultSpec(corrupt_rate=1.0), inner=OracleRemote(oracle))
    assert r.outcome(0).kind == "corrupt"
    ids, d2 = r.fetch(reqs[:2], 4, t=0)
    assert np.isnan(d2).any() and not payload_ok(ids, d2)
    ids2, d22 = FaultyRemote(FaultSpec(), inner=OracleRemote(oracle)).fetch(reqs[:2], 4)
    jids, jd2 = JR.OracleRemote(joracle).fetch(reqs[:2], 4)
    np.testing.assert_array_equal(ids2, jids)
    np.testing.assert_allclose(d22, jd2, rtol=1e-5, atol=1e-5)
    assert payload_ok(ids2, d22) and not payload_ok(None)
    # torch tensors are checked too, on any device
    assert payload_ok(torch.zeros(3), torch.arange(3))
    assert not payload_ok(torch.tensor([0.0, float("inf")]))
    with pytest.raises(ValueError, match="answer_fn"):
        OracleRemote().fetch(reqs[:1], 4)


# ---------------------------------------------------------------------------
# retry / backoff / hedge / deadline / breaker: equal to the reference
# ---------------------------------------------------------------------------

def test_backoff_equals_reference():
    for rc_kw in (dict(backoff_ms=10.0, backoff_cap_ms=35.0, jitter=0.2),
                  dict(backoff_ms=10.0, jitter=0.0), dict()):
        rc, jrc = RetryConfig(**rc_kw), JRes.RetryConfig(**rc_kw)
        for seed, t, a in ((0, 7, 0), (0, 7, 1), (1, 7, 2), (3, 99, 5)):
            assert Res._backoff_ms(rc, seed, t, a) == JRes._backoff_ms(jrc, seed, t, a)


def _configs():
    return [
        (dict(deadline_ms=None), {}),
        (dict(deadline_ms=250.0), {}),
        (dict(deadline_ms=60.0, hedge_ms=20.0), dict(max_retries=4, attempt_timeout_ms=30.0)),
        (dict(deadline_ms=None, hedge_ms=10.0), dict(attempt_timeout_ms=None)),
        (dict(deadline_ms=100.0), dict(max_retries=0, jitter=0.0)),
    ]


@pytest.mark.parametrize("cfg_i", range(5))
@pytest.mark.parametrize("fault_i", [0, 1, 3])
def test_simulate_request_and_breaker_log_equal_reference(cfg_i, fault_i):
    """Every request's report and the breaker's decision log equal the
    reference's over 200 requests (a breaker that trips quickly)."""
    top, retry = _configs()[cfg_i]
    brk = dict(failure_threshold=3, cooldown_requests=10)
    cfg = ResilienceConfig(retry=RetryConfig(**retry), breaker=BreakerConfig(**brk), **top)
    jcfg = JRes.ResilienceConfig(retry=JRes.RetryConfig(**retry),
                                 breaker=JRes.BreakerConfig(**brk), **top)
    port, ref = _pair_remote(FAULTS[fault_i])
    pb, jb = CircuitBreaker(cfg.breaker), JRes.CircuitBreaker(jcfg.breaker)
    for t in range(200):
        got = simulate_request(port, t, cfg, pb)
        want = JRes.simulate_request(ref, t, jcfg, jb)
        assert tuple(got) == tuple(want), t
    assert pb.log == jb.log and pb.state == jb.state


class _Scripted:
    """attempt -> Outcome table (default ok at 5 ms)."""

    def __init__(self, table):
        self.table = table

    def outcome(self, t, attempt=0):
        kind, lat = self.table.get(attempt, ("ok", 5.0))
        return R.Outcome(kind, lat)


def test_hedge_and_deadline_semantics():
    cfg = ResilienceConfig(deadline_ms=None, hedge_ms=50.0)
    rep = simulate_request(_Scripted({0: ("ok", 200.0),
                                      Res.HEDGE_ATTEMPT_OFFSET: ("ok", 10.0)}), 0, cfg)
    assert rep.ok and rep.hedged and rep.latency_ms == 60.0
    rep = simulate_request(_Scripted({0: ("ok", 20.0)}), 0, cfg)
    assert rep.ok and not rep.hedged and rep.latency_ms == 20.0
    cfg = ResilienceConfig(deadline_ms=100.0, retry=RetryConfig(attempt_timeout_ms=None))
    rep = simulate_request(_Scripted({0: ("ok", 150.0)}), 0, cfg)
    assert not rep.ok and rep.deadline_miss and rep.failure_kind == "deadline"
    cfg = ResilienceConfig(deadline_ms=None,
                           retry=RetryConfig(max_retries=0, attempt_timeout_ms=100.0))
    rep = simulate_request(_Scripted({0: ("ok", 150.0)}), 0, cfg)
    assert not rep.ok and rep.failure_kind == "timeout" and rep.latency_ms == 100.0


def test_breaker_state_machine():
    br = CircuitBreaker(BreakerConfig(failure_threshold=3, cooldown_requests=10))
    jbr = JRes.CircuitBreaker(JRes.BreakerConfig(failure_threshold=3,
                                                 cooldown_requests=10))
    script = [(t, False) for t in range(3)] + [(5, None), (11, None), (12, False),
                                               (13, None), (22, True), (23, False),
                                               (24, True), (25, False), (26, False)]
    for t, ok in script:
        assert br.allow(t) == jbr.allow(t)
        if ok is not None:
            br.record(t, ok)
            jbr.record(t, ok)
        assert br.state == jbr.state
    assert br.log == jbr.log and br.transitions == jbr.transitions == 5


def test_session_counters_and_percentiles_equal_reference():
    kw = dict(error_rate=0.3, latency_sigma=0.6, outages=((40, 60),), seed=4)
    port, ref = _pair_remote(kw)
    ses, jses = Res.RemoteSession(port), JRes.RemoteSession(ref)
    for b in (8, 8, 5, 16, 8, 27, 8):
        got, want = ses.simulate_batch(b), jses.simulate_batch(b)
        assert [tuple(r) for r in got] == [tuple(r) for r in want]
    assert ses.counters.to_dict() == jses.counters.to_dict()
    assert ses.latency_percentiles() == jses.latency_percentiles()
    assert ses.breaker.log == jses.breaker.log


def test_straggler_monitor_equals_reference():
    rng = np.random.default_rng(0)
    times = np.concatenate([rng.lognormal(0, 0.3, 60), [9.0], rng.lognormal(0, 1.0, 60)])
    mon, jmon = StragglerMonitor(threshold=2.0, window=8, quiet=True), JStraggler(
        threshold=2.0, window=8, quiet=True)
    got = [mon.record(i, float(s)) for i, s in enumerate(times)]
    want = [jmon.record(i, float(s)) for i, s in enumerate(times)]
    assert got == want and mon.flagged == jmon.flagged and any(got)
    warm = StragglerMonitor(threshold=2.0, window=8)
    for i, s in enumerate([1.0, 1.0, 1.0, 5.0, 5.0]):
        warm.record(i, s)
    assert warm.record(5, 6.5) and warm.flagged[-1] == (5, 6.5)


# ---------------------------------------------------------------------------
# the degraded serve and step against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ceiling", [0.5, 2.0, 8.0])
def test_degraded_serve_matches_reference(ceiling):
    rng = np.random.default_rng(1)
    b, c, k, c_f = 16, 24, 4, 0.7
    d = (rng.random((b, c)) * 3).astype(np.float32)
    d[:, -3:] = 1e6  # invalid slots (BIG_COST-like)
    x = (rng.random((b, c)) < 0.3).astype(np.float32)
    x[0] = 0.0       # a row with nothing cached: shed
    got = Res.degraded_serve_batch(torch.from_numpy(d), torch.from_numpy(x), k, c_f,
                                   ceiling)
    want = JRes.degraded_serve_batch(jnp.asarray(d), jnp.asarray(x), k, c_f, ceiling)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    one = Res.degraded_serve(torch.from_numpy(d[1]), torch.from_numpy(x[1]), k, c_f,
                             ceiling)
    assert float(one[0]) == float(got[0][1]) and bool(one[3]) == bool(got[3][1])


@pytest.mark.parametrize("ok_pattern", ["none", "mixed", "all"])
def test_degraded_step_matches_reference(setup, ok_pattern):
    """make_degraded_step on one candidate slab, the reference's k_round
    uniforms injected: y to 1e-6, x and the flags exact, and the state's
    step and the next uniforms line up (the key is split on a frozen
    step too)."""
    catalog, reqs, _ = setup
    jcfg = jpolicy.AcaiConfig(h=16, k=4, c_f=1.0, c_remote=12, c_local=8)
    tcfg = policy.AcaiConfig(h=16, k=4, c_f=1.0, c_remote=12, c_local=8)
    jfn = jpolicy.exact_candidate_fn_batched(jnp.asarray(catalog), 12, 8)
    jstate = jpolicy.init_state(catalog.shape[0], jcfg, seed=0)
    tstate = convert.cache_state_from_numpy(np.asarray(jstate.y), np.asarray(jstate.x),
                                            0, device="cpu")
    ok = {"none": np.zeros(8, bool), "all": np.ones(8, bool),
          "mixed": np.array([1, 0, 1, 1, 0, 0, 1, 0], bool)}[ok_pattern]
    jstep = JRes.make_degraded_step(jcfg, 8, 2.0)
    tstep = Res.make_degraded_step(tcfg, 8, 2.0)
    alive = np.ones(catalog.shape[0], bool)
    us = reference_uniforms(jstate.key, catalog.shape[0], 2)
    for i in range(2):
        rs = reqs[8 * i:8 * i + 8]
        ids, d, valid = jfn(jnp.asarray(rs), jstate.x)
        jstate, jm = jstep(jstate, ids, d, valid, jnp.asarray(ok), jnp.asarray(alive))
        tstate, tm = tstep(tstate, torch.from_numpy(np.array(ids)).long(),
                           torch.from_numpy(np.array(d)),
                           torch.from_numpy(np.array(valid)), ok,
                           torch.from_numpy(alive), torch.from_numpy(us[i]))
        np.testing.assert_allclose(tstate.y.numpy(), np.asarray(jstate.y), rtol=1e-5,
                                   atol=TOL)
        np.testing.assert_array_equal(tstate.x.numpy(), np.asarray(jstate.x))
        assert tstate.t == int(jstate.t)
        for f in ("gain_int", "gain_frac", "cost", "occupancy"):
            np.testing.assert_allclose(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                       rtol=1e-5, atol=TOL, err_msg=f)
        for f in ("served_local", "fetched", "degraded", "shed", "remote_failures"):
            np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                          np.asarray(getattr(jm, f)), err_msg=f)
    if ok_pattern == "none":
        np.testing.assert_array_equal(tstate.x.numpy(), np.asarray(
            jpolicy.init_state(catalog.shape[0], jcfg, seed=0).x))


def test_degraded_step_draws_a_frozen_steps_uniforms(setup):
    """A fully failed batch still consumes one step's uniforms from the
    state's generator, so the next step rounds with what it would have
    drawn after a healthy step."""
    catalog, reqs, _ = setup
    cfg = policy.AcaiConfig(h=16, k=4, c_f=1.0, c_remote=12, c_local=8)
    fn = policy.exact_candidate_fn_batched(torch.from_numpy(catalog), 12, 8)
    st = policy.init_state(catalog.shape[0], cfg, seed=3, device="cpu")
    step = Res.make_degraded_step(cfg, 8, 2.0)
    st2, _ = step(st, *fn(torch.from_numpy(reqs[:8]), st.x), np.zeros(8, bool), None)
    ref = torch.Generator().manual_seed(3)
    torch.rand(catalog.shape[0], generator=ref)
    assert torch.equal(policy.draw_uniforms(st2),
                       torch.rand(catalog.shape[0], generator=ref))


# ---------------------------------------------------------------------------
# resilient replays: the port's pins and the reference's numbers
# ---------------------------------------------------------------------------

def test_fault_rate_zero_bitwise_parity(setup):
    catalog, reqs, cm = setup
    spec = PA.PolicySpec("acai", TINY["acai"])
    res_pol = ResilientPolicy(PA.build_policy(spec, catalog, cm, seed=0, device="cpu"),
                              remote=FaultyRemote(FaultSpec()),
                              resilience=ResilienceConfig())
    ref_pol = PA.build_policy(spec, catalog, cm, seed=0, device="cpu")
    got = replay_resilient(res_pol, reqs, batch=8)
    ref = ref_pol.replay(reqs)
    assert np.array_equal(got["gain"], ref["gain"])
    assert torch.equal(res_pol.inner.cache.state.y, ref_pol.cache.state.y)
    assert torch.equal(res_pol.inner.cache.state.x, ref_pol.cache.state.x)
    assert got["counters"]["remote_failures"] == 0
    assert got["goodput"] == 1.0 and got["degraded_share"] == 0.0


def test_outage_degrades_freezes_x_keeps_state_finite(setup):
    catalog, reqs, cm = setup
    pol = ResilientPolicy(
        PA.build_policy(PA.PolicySpec("acai", TINY["acai"]), catalog, cm, seed=0,
                        device="cpu"),
        remote=FaultyRemote(FaultSpec(outages=((0, 10 ** 9),))),
        resilience=ResilienceConfig())
    cache = pol.inner.cache
    x0, y0 = cache.state.x.clone(), cache.state.y.clone()
    m = pol.serve_update_batch(reqs[:8])
    assert int(m.remote_failures.sum()) == 8
    assert int((m.degraded + m.shed).sum()) == 8
    assert torch.equal(cache.state.x, x0)
    assert not torch.equal(cache.state.y, y0) and torch.isfinite(cache.state.y).all()
    deg = m.degraded.bool()
    assert (m.cost[deg] >= 0).all() and (m.served_local[deg] > 0).all()
    assert (m.served_local[m.shed.bool()] == 0).all()


@pytest.mark.parametrize("fault", [dict(error_rate=0.4, seed=1),
                                   dict(outages=((24, 56),), seed=0),
                                   dict(error_rate=0.2, corrupt_rate=0.1,
                                        latency_sigma=0.5, seed=5)])
def test_acai_resilient_replay_matches_reference(setup, fault):
    """AÇAI through the resilient tier, port against reference with the
    reference's uniforms: counters and breaker log exactly, per-request
    gain to 1e-5, degraded / shed flags exactly."""
    catalog, reqs, cm = setup
    kw = dict(TINY["acai"], rounding="coupled")
    jpol = JRes.ResilientPolicy(
        JPA.build_policy(JPA.PolicySpec("acai", kw), jnp.asarray(catalog),
                         JCostModel(c_f=1.0), seed=0),
        remote=JR.FaultyRemote(JR.FaultSpec(**fault)),
        resilience=JRes.ResilienceConfig())
    pol = ResilientPolicy(PA.build_policy(PA.PolicySpec("acai", kw), catalog, cm, seed=0,
                                          device="cpu"),
                          remote=FaultyRemote(FaultSpec(**fault)),
                          resilience=ResilienceConfig())
    st = jpol.inner.cache.state
    pol.inner.cache.state = convert.cache_state_from_numpy(
        np.asarray(st.y), np.asarray(st.x), int(st.t), device="cpu")
    us = reference_uniforms(st.key, st.y.shape[0], reqs.shape[0] // 8)
    got = replay_resilient(pol, reqs, batch=8, uniforms=torch.from_numpy(us))
    want = JRes.replay_resilient(jpol, reqs, batch=8)
    assert got["counters"] == want["counters"]
    assert got["breaker_log"] == want["breaker_log"]
    for f in ("p50_ms", "p99_ms", "goodput", "degraded_share", "shed_share"):
        assert got[f] == want[f], f
    for f in ("degraded", "shed", "remote_failures", "retries", "deadline_misses"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_allclose(got["gain"], want["gain"], rtol=1e-5, atol=1e-5 * 4)
    np.testing.assert_array_equal(got["served_local"], want["served_local"])


@pytest.mark.parametrize("name", ["lru", "sim_lru", "cls_lru", "rnd_lru", "qcache"])
def test_baseline_resilient_replay_matches_reference(setup, name):
    """Each baseline through the resilient tier (a healthy prefix, an
    outage, flaky tail): counters exactly, gains to 1e-5."""
    catalog, reqs, cm = setup
    fault = dict(error_rate=0.25, outages=((48, 72),), seed=2)
    jpol = JRes.ResilientPolicy(
        JPA.build_policy(JPA.PolicySpec(name, TINY[name]), jnp.asarray(catalog),
                         JCostModel(c_f=1.0), seed=0),
        remote=JR.FaultyRemote(JR.FaultSpec(**fault)))
    pol = ResilientPolicy(PA.build_policy(PA.PolicySpec(name, TINY[name]), catalog, cm,
                                          seed=0, device="cpu"),
                          remote=FaultyRemote(FaultSpec(**fault)))
    got = replay_resilient(pol, reqs, batch=8)
    want = JRes.replay_resilient(jpol, reqs, batch=8)
    assert got["counters"] == want["counters"]
    for f in ("degraded", "shed", "remote_failures"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_allclose(got["gain"], want["gain"], rtol=1e-5, atol=1e-5 * 4)
    m = pol.serve_update_batch(reqs[:8])
    for f in policy.StepMetrics._fields:
        assert getattr(m, f).shape == (8,), f
    assert pol.serve_update(reqs[0]).gain_int.shape == ()


def test_step_degraded_matches_reference(setup):
    catalog, _, cm = setup
    oracle = B.ServerOracle(catalog, kmax=16, device="cpu")
    joracle = JB.ServerOracle(catalog, kmax=16)
    kw = dict(h=16, k=4, k_prime=8, c_theta=1.5, c_f=cm.c_f)
    pol, jpol = B.SimLRU(catalog, oracle, **kw), JB.SimLRU(catalog, joracle, **kw)
    probe = catalog[0] + 0.01 * np.random.default_rng(0).normal(size=16).astype(np.float32)
    for p in (pol, jpol):
        res, shed = p.step_degraded(probe)
        assert shed and res.gain == 0.0 and res.served_local == 0
    ts, jts = oracle.extend(catalog[:8]), joracle.extend(catalog[:8])
    for t, jt, r in zip(ts, jts, catalog[:8]):
        pol.step(int(t), r)
        jpol.step(int(jt), r)
    before = list(pol.entries)
    for q, c in ((catalog[7], 2.0), (catalog[3], 0.5), (probe, 8.0)):
        (res, shed), (jres, jshed) = pol.step_degraded(q, ceiling=c), jpol.step_degraded(
            q, ceiling=c)
        assert shed == jshed and res.served_local == jres.served_local
        assert res.fetched == 0
        np.testing.assert_allclose([res.gain, res.cost], [jres.gain, jres.cost],
                                   rtol=1e-5, atol=1e-5)
    assert list(pol.entries) == before
