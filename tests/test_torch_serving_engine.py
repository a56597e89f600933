"""Port parity, the online serving engine: repro_torch.serve.arrivals /
queue and policy_api.replay_trace_online against the reference's, on the
CPU.

Held exactly (host code on the virtual clock, ported line for line): the
arrival schedules (open and closed loop), the engine's timestamps, batch
partition, shed decisions and reasons, batch histograms, latency
percentiles and goodput, for a stub policy and for every registered
policy.  Gains: the baselines to 1e-5; AÇAI, given the reference's
`k_round` uniforms step by step, to 1e-5 as well.  The fixed-window pin
(the engine equals `AcaiPolicy.replay` on gain, y and x) is the port's
own and bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpolicy
from repro.core import policy_api as JPA
from repro.core import trace as jtrace
from repro.core.costs import CostModel as JCostModel
from repro.serve import arrivals as JArr
from repro.serve import queue as JQ
from repro_torch import convert
from repro_torch.core import policy_api as PA
from repro_torch.core.churn import warm_size
from repro_torch.core.costs import CostModel
from repro_torch.core.policy import StepMetrics, shed_only_metrics
from repro_torch.core.trace import rolling_catalog_events
from repro_torch.serve.arrivals import (ArrivalSpec, ClosedLoopSource, OpenLoopSource,
                                        arrival_times, make_source)
from repro_torch.serve.queue import (AdmissionConfig, BatchFormerConfig,
                                     OnlineServingEngine, ServiceModel,
                                     fixed_window_engine, serve_trace_online)

TINY = PA.TINY_POLICY_KWARGS
TIMES = ("arrival_ms", "form_ms", "done_ms", "queue_ms", "service_ms", "latency_ms",
         "shed", "user_latency_ms")
SCALARS = ("requests", "served", "shed_total", "shed_share", "p50_ms", "p99_ms",
           "p999_ms", "queue_p50_ms", "queue_p99_ms", "service_p50_ms", "mean_batch",
           "batches", "max_queue_depth", "events_applied", "batch_hist", "shed_reasons")


def reference_uniforms(key, n: int, steps: int) -> np.ndarray:
    out = np.empty((steps, n), np.float32)
    for i in range(steps):
        key, k_round = jax.random.split(key)
        out[i] = np.asarray(jax.random.uniform(k_round, (n,), dtype=jnp.float32))
    return out


class StubPolicy:
    """Unit gain a request; records every batch it served (the request
    vectors carry their rid in component 0)."""

    k, c_f, h = 1, 1.0, 4

    def __init__(self, shed_only):
        self.batches = []
        self.shed_only = shed_only

    def serve_update_batch(self, rs, ts=None):
        rs = np.atleast_2d(np.asarray(rs))
        self.batches.append([int(r[0]) for r in rs])
        b = rs.shape[0]
        base = self.shed_only(b)
        ones = np.ones(b) if isinstance(base.gain_int, np.ndarray) else torch.ones(b)
        zeros = (np.zeros(b, np.int32) if isinstance(base.shed, np.ndarray)
                 else torch.zeros(b, dtype=torch.int32))
        return base._replace(gain_int=ones, shed=zeros)


def id_requests(t: int, d: int = 4) -> np.ndarray:
    reqs = np.zeros((t, d), np.float32)
    reqs[:, 0] = np.arange(t)
    return reqs


def tiny_setup(n=256, d=16, t=128, seed=0):
    catalog, reqs, _ = jtrace.sift_like(n, d, t, seed=seed)
    return np.asarray(catalog), np.asarray(reqs), CostModel(c_f=1.0)


def check_same(got, want, gains_tol=None):
    for f in TIMES:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in SCALARS:
        assert got[f] == want[f], f
    for f in ("goodput_slo", "answer_hit_rate"):
        assert got.get(f) == want.get(f), f
    if gains_tol is None:
        np.testing.assert_array_equal(got["gain"], want["gain"])
    else:
        np.testing.assert_allclose(got["gain"], want["gain"], rtol=1e-5, atol=gains_tol)


# ---------------------------------------------------------------------------
# arrival processes: the reference's schedules exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["poisson", "flash_crowd"])
@pytest.mark.parametrize("seed,rate", [(5, 1000.0), (6, 37.5), (0, 12000.0)])
def test_open_loop_times_equal_reference(kind, seed, rate):
    got = arrival_times(ArrivalSpec(kind=kind, rate_rps=rate, seed=seed), 3000)
    want = JArr.arrival_times(JArr.ArrivalSpec(kind=kind, rate_rps=rate, seed=seed), 3000)
    np.testing.assert_array_equal(got, want)
    assert (np.diff(got) >= 0).all()
    np.testing.assert_array_equal(got[:100], arrival_times(
        ArrivalSpec(kind=kind, rate_rps=rate, seed=seed), 100))


def test_flash_crowd_concentrates_in_bursts():
    spec = ArrivalSpec(kind="flash_crowd", rate_rps=1000.0, burst_factor=8.0,
                       burst_every_ms=250.0, burst_width_ms=50.0, seed=5)
    t = arrival_times(spec, 5000)
    assert ((t % 250.0) < 50.0).mean() > 2 * 50.0 / 250.0
    assert t[-1] / len(t) == pytest.approx(1.0, rel=0.1)


@pytest.mark.parametrize("order", [[0, 1, 2], [2, 0, 1]])
def test_closed_loop_equals_reference(order):
    """The same completions in the same order give the reference's next
    arrivals; the drain order does not change them."""
    kw = dict(kind="closed_loop", users=3, think_ms=4.0, seed=2)

    def wave(src):
        first = [src.pop() for _ in range(3)]
        for idx in order:
            src.on_complete(first[idx][1], 10.0)
        out = {}
        while src.peek() is not None:
            tm, rid = src.pop()
            out[rid] = tm
            src.on_complete(rid, tm + 1.5)
        return first, out

    assert wave(ClosedLoopSource(ArrivalSpec(**kw), 9)) == wave(
        JArr.ClosedLoopSource(JArr.ArrivalSpec(**kw), 9))


def test_closed_loop_bounds_and_double_complete():
    src = ClosedLoopSource(ArrivalSpec(kind="closed_loop", users=2, think_ms=1.0), 10)
    t1, t2 = src.pop(), src.pop()
    assert src.peek() is None
    src.on_complete(t1[1], 5.0)
    assert src.peek() is not None
    one = ClosedLoopSource(ArrivalSpec(kind="closed_loop", users=1, think_ms=0.0), 5)
    _, rid = one.pop()
    one.on_complete(rid, 1.0)
    one.on_complete(rid, 2.0)
    assert one.pop()[0] == 1.0 and one._heap == []


def test_arrival_spec_validation_and_sources():
    for kw in ({"kind": "uniform"}, {"kind": "poisson", "rate_rps": 0.0},
               {"kind": "flash_crowd", "burst_width_ms": 300.0, "burst_every_ms": 250.0},
               {"kind": "closed_loop", "users": 0}):
        with pytest.raises(ValueError):
            ArrivalSpec(**kw)
    with pytest.raises(ValueError):
        arrival_times(ArrivalSpec(kind="closed_loop"), 10)
    with pytest.raises(ValueError):
        OpenLoopSource(np.array([2.0, 1.0]))
    spec = ArrivalSpec(kind="poisson", rate_rps=10.0, seed=1)
    assert ArrivalSpec.from_dict(spec.to_dict()) == spec
    assert spec.to_dict() == JArr.ArrivalSpec(kind="poisson", rate_rps=10.0,
                                              seed=1).to_dict()
    assert isinstance(make_source(spec, 5), OpenLoopSource)
    assert isinstance(make_source(ArrivalSpec(kind="closed_loop"), 5), ClosedLoopSource)
    src = OpenLoopSource(np.zeros(3))
    assert make_source(src, 3) is src
    assert make_source(np.arange(6.0), 4).pop() == (0.0, 0)


# ---------------------------------------------------------------------------
# the queue with a stub policy: timestamps and partition exactly
# ---------------------------------------------------------------------------

ENGINE_CASES = [
    ([0.0] * 8, dict(max_batch=4, max_wait_ms=100.0), {}, {}),
    ([0.0, 1.0, 50.0, 120.0], dict(max_batch=8, max_wait_ms=5.0), {}, {}),
    (list(np.arange(20) * 40.0), dict(max_batch=8, max_wait_ms=6.0), {}, {}),
    ([0.0] * 10, dict(max_batch=4, max_wait_ms=None), {}, {}),
    ([0.0] * 10, dict(max_batch=2, max_wait_ms=None), dict(queue_cap=4), {}),
    ([0.0] * 30, dict(max_batch=2, max_wait_ms=None), dict(deadline_ms=10.0), {}),
    ([0.0] * 8, dict(max_batch=2, max_wait_ms=None), {}, dict(slo_ms=7.0)),
    ("poisson", dict(max_batch=8, max_wait_ms=3.0), dict(queue_cap=16, deadline_ms=20.0),
     dict(slo_ms=12.0)),
    ("flash_crowd", dict(max_batch=8, max_wait_ms=2.0), dict(queue_cap=24),
     dict(slo_ms=15.0)),
    ("closed_loop", dict(max_batch=4, max_wait_ms=1.0), {}, dict(slo_ms=10.0)),
]


@pytest.mark.parametrize("case", range(len(ENGINE_CASES)))
def test_engine_equals_reference_on_a_stub(case):
    times, former, admission, run_kw = ENGINE_CASES[case]
    service = dict(base_ms=2.0, per_request_ms=0.5)
    t = 200 if isinstance(times, str) else len(times)
    if isinstance(times, str):
        arr, jarr = (ArrivalSpec(kind=times, rate_rps=1800.0, users=6, think_ms=3.0,
                                 seed=7),
                     JArr.ArrivalSpec(kind=times, rate_rps=1800.0, users=6, think_ms=3.0,
                                      seed=7))
    else:
        arr = jarr = np.asarray(times, float)
    pol, jpol = StubPolicy(shed_only_metrics), StubPolicy(jpolicy.shed_only_metrics)
    got = OnlineServingEngine(pol, former=BatchFormerConfig(**former),
                              admission=AdmissionConfig(**admission),
                              service=ServiceModel(**service)).run(
        id_requests(t), arr, **run_kw)
    want = JQ.OnlineServingEngine(jpol, former=JQ.BatchFormerConfig(**former),
                                  admission=JQ.AdmissionConfig(**admission),
                                  service=JQ.ServiceModel(**service)).run(
        id_requests(t), jarr, **run_kw)
    assert pol.batches == jpol.batches
    check_same(got, want)
    for f in StepMetrics._fields:
        np.testing.assert_array_equal(getattr(got["metrics"], f).numpy(),
                                      np.asarray(getattr(want["metrics"], f)), err_msg=f)


def test_config_validation_and_service_model():
    for make in (lambda: BatchFormerConfig(max_batch=0),
                 lambda: BatchFormerConfig(max_wait_ms=-1.0),
                 lambda: AdmissionConfig(queue_cap=0),
                 lambda: AdmissionConfig(deadline_ms=0.0),
                 lambda: ServiceModel(base_ms=0.0, per_request_ms=0.0),
                 lambda: ServiceModel.fit({8: 3.0})):
        with pytest.raises(ValueError):
            make()
    sm = ServiceModel()
    assert sm.capacity_rps(8) == JQ.ServiceModel().capacity_rps(8) == 2000.0
    fit = ServiceModel.fit({8: 2.4, 64: 9.4})
    assert fit.base_ms == pytest.approx(1.4) and fit.per_request_ms == pytest.approx(0.125)
    assert fit.service_ms(8) == pytest.approx(2.4)


def test_shed_only_metrics_and_tail_events():
    got, want = shed_only_metrics(5), jpolicy.shed_only_metrics(5)
    for f in StepMetrics._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f), err_msg=f)
    with pytest.raises(ValueError, match="catalog"):
        OnlineServingEngine(StubPolicy(shed_only_metrics)).run(
            id_requests(8), np.zeros(8), events=[(4, np.array([1]), np.array([], int))])


# ---------------------------------------------------------------------------
# real policies: the fixed-window pin and the reference's numbers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arrival_kind", ["poisson", "flash_crowd"])
def test_fixed_window_bitwise_equals_offline_replay(arrival_kind):
    catalog, reqs, cm = tiny_setup()
    spec = PA.PolicySpec("acai", TINY["acai"])
    b = TINY["acai"]["batch"]
    pol_on = PA.build_policy(spec, catalog, cm, seed=0, device="cpu")
    pol_off = PA.build_policy(spec, catalog, cm, seed=0, device="cpu")
    res = fixed_window_engine(pol_on, b).run(
        reqs, ArrivalSpec(kind=arrival_kind, rate_rps=3000.0, seed=4))
    ref = pol_off.replay(reqs)
    assert np.array_equal(res["gain"], ref["gain"])
    assert torch.equal(pol_on.cache.state.y, pol_off.cache.state.y)
    assert torch.equal(pol_on.cache.state.x, pol_off.cache.state.x)


class _Injected:
    """A port AÇAI policy fed the reference's uniforms, one row a step."""

    def __init__(self, pol, us):
        self.pol, self.us, self.i = pol, us, 0

    def __getattr__(self, name):
        return getattr(self.pol, name)

    def serve_update_batch(self, rs, ts=None):
        u = torch.from_numpy(self.us[self.i])
        self.i += 1
        return self.pol.serve_update_batch(rs, ts, u=u)


def _acai_pair(catalog, cm, kw):
    jpol = JPA.build_policy(JPA.PolicySpec("acai", kw), jnp.asarray(catalog),
                            JCostModel(c_f=cm.c_f), seed=0)
    pol = PA.build_policy(PA.PolicySpec("acai", kw), catalog, cm, seed=0, device="cpu")
    st = jpol.cache.state
    pol.cache.state = convert.cache_state_from_numpy(np.asarray(st.y), np.asarray(st.x),
                                                     int(st.t), device="cpu")
    return _Injected(pol, reference_uniforms(st.key, st.y.shape[0], 64)), jpol


@pytest.mark.parametrize("name", PA.registered_policies())
def test_replay_trace_online_equals_reference(name):
    """Every registered policy through replay_trace_online and the
    reference's serve_trace_online, dynamic window and admission control:
    timestamps, partition and sheds exactly, gains to 1e-5."""
    catalog, reqs, cm = tiny_setup(t=96)
    kw = dict(TINY[name], rounding="coupled") if name == "acai" else TINY[name]
    if name == "acai":
        pol, jpol = _acai_pair(catalog, cm, kw)
    else:
        pol = PA.build_policy(PA.PolicySpec(name, kw), catalog, cm, seed=0, device="cpu")
        jpol = JPA.build_policy(JPA.PolicySpec(name, kw), jnp.asarray(catalog),
                                JCostModel(c_f=1.0), seed=0)
    got = PA.replay_trace_online(
        pol, reqs, ArrivalSpec(kind="poisson", rate_rps=2500.0, seed=1),
        former=BatchFormerConfig(max_batch=8, max_wait_ms=4.0),
        admission=AdmissionConfig(queue_cap=32, deadline_ms=12.0), slo_ms=25.0)
    want = JPA.replay_trace_online(
        jpol, reqs, JArr.ArrivalSpec(kind="poisson", rate_rps=2500.0, seed=1),
        former=JQ.BatchFormerConfig(max_batch=8, max_wait_ms=4.0),
        admission=JQ.AdmissionConfig(queue_cap=32, deadline_ms=12.0), slo_ms=25.0)
    check_same(got, want, gains_tol=1e-5 * TINY[name]["k"])
    assert got["batches"] > 1 and len(got["batch_hist"]) > 1
    nag = pol.normalized_gain(float(got["gain"].sum()), got["requests"])
    jnag = jpol.normalized_gain(float(want["gain"].sum()), want["requests"])
    assert nag == pytest.approx(jnag, abs=1e-5)


@pytest.mark.parametrize("name", ["acai", "sim_lru"])
def test_interleaved_churn_equals_reference(name):
    """rolling_catalog events between formed batches: every event fires at
    the reference's instant, and no removed object stays cached."""
    catalog, reqs, cm = tiny_setup(n=256, t=96)
    events = rolling_catalog_events(256, 96, churn_rate=0.15, warm=0.5)
    jevents = jtrace.rolling_catalog_events(256, 96, churn_rate=0.15, warm=0.5)
    assert len(events) == len(jevents) > 0
    w = warm_size(256, 0.5)
    pol = PA.build_policy(PA.PolicySpec(name, TINY[name]), catalog[:w], cm, seed=0,
                          device="cpu")
    jpol = JPA.build_policy(JPA.PolicySpec(name, TINY[name]), jnp.asarray(catalog[:w]),
                            JCostModel(c_f=1.0), seed=0)
    arr = dict(kind="poisson", rate_rps=1500.0, seed=6)
    got = serve_trace_online(pol, reqs, ArrivalSpec(**arr),
                             former=BatchFormerConfig(max_batch=8, max_wait_ms=4.0),
                             catalog=catalog, events=events)
    want = JQ.serve_trace_online(jpol, reqs, JArr.ArrivalSpec(**arr),
                                 former=JQ.BatchFormerConfig(max_batch=8, max_wait_ms=4.0),
                                 catalog=catalog, events=jevents)
    for f in TIMES:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert got["events_applied"] == want["events_applied"] == len(events)
    assert got["batch_hist"] == want["batch_hist"]
    removed = np.concatenate([np.asarray(ev[2]) for ev in events])
    if name == "acai":
        assert float(pol.cache.state.y[removed].abs().sum()) == 0.0
        assert float(pol.cache.state.x[removed].abs().sum()) == 0.0
    else:
        assert not set(removed.tolist()) & set(pol.policy.cached_object_ids().tolist())
        np.testing.assert_allclose(got["gain"], want["gain"], rtol=1e-5, atol=4e-5)


def test_engine_is_reproducible_and_drains_tail_events():
    catalog, reqs, cm = tiny_setup(n=64, t=16)
    pol = PA.build_policy(PA.PolicySpec("sim_lru", TINY["sim_lru"]), catalog[:32], cm,
                          seed=0, device="cpu")
    events = [(15, np.array([32]), np.array([0])), (500, np.array([33]), np.array([1]))]
    res = serve_trace_online(pol, reqs, np.zeros(16), catalog=catalog, events=events)
    assert res["events_applied"] == 2
    assert not {0, 1} & set(pol.policy.cached_object_ids().tolist())
    outs = [serve_trace_online(PA.build_policy(PA.PolicySpec("lru", TINY["lru"]), catalog,
                                               cm, seed=0, device="cpu"), reqs,
                               ArrivalSpec(kind="poisson", rate_rps=2000.0, seed=3),
                               former=BatchFormerConfig(max_batch=4, max_wait_ms=3.0))
            for _ in range(2)]
    for key in ("gain", "arrival_ms", "form_ms", "done_ms", "latency_ms"):
        assert np.array_equal(outs[0][key], outs[1][key]), key
