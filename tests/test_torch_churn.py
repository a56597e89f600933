"""Port parity, the churn replay: repro_torch's `replay_with_churn` against
repro's on the tiny `rolling_catalog` trace (AÇAI exact and over IVF,
SIM-LRU), the semantic tier's mutation, and the launcher's churn flags, on
the CPU.

The port's AÇAI runs from the reference's initial state with the
reference's rounding uniforms (`k_round` of each step, over the state's
length at that step, which is the slab's capacity), and the IVF builds
from the reference's initial k-means rows.  Tolerances (ROADMAP's rule):
served flags, x, occupancy, capacities and counts exact; gains and y to
1e-5; NAG to 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import churn as jchurn
from repro.core import oma as joma
from repro.core import policy as jpol
from repro.core import policy_api as JPA
from repro.core import trace as jtrace
from repro.core.costs import CostModel as JCostModel
from repro.index import IndexSpec as JSpec
from repro_torch import convert
from repro_torch.core import churn as tchurn
from repro_torch.core import oma as toma
from repro_torch.core import policy as tpol
from repro_torch.core import policy_api as TPA
from repro_torch.core.costs import CostModel
from repro_torch.index.base import IndexSpec

RTOL = 1e-5
IVF = {"nlist": 8, "nprobe": 4}


def _t(a):
    return torch.from_numpy(np.array(a))


def jinit(seed: int):
    def fn(n, k):
        return np.array(jax.random.choice(jax.random.PRNGKey(seed), n, shape=(k,),
                                          replace=False))
    return fn


class RefUniforms:
    """uniforms_fn(i, n): the reference AcaiCache's rounding uniforms of
    step i over n rows (k_round of the i-th split of its state key;
    DepRound draws n - 1 and the port reads the first n - 1)."""

    def __init__(self, key, rounding: str):
        self.key, self.rounding, self.rounds = key, rounding, []

    def __call__(self, i: int, n: int):
        while len(self.rounds) <= i:
            self.key, k_round = jax.random.split(self.key)
            self.rounds.append(k_round)
        m = n - 1 if self.rounding == "depround" else n
        u = np.asarray(jax.random.uniform(self.rounds[i], (m,), dtype=jnp.float32))
        return np.concatenate([u, np.zeros(n - m, np.float32)])


def _cfgs(rounding="depround"):
    kw = dict(h=24, k=4, c_f=1.0, c_remote=16, c_local=8)
    return (jpol.AcaiConfig(**kw, oma=joma.OMAConfig(eta=0.05, rounding=rounding)),
            tpol.AcaiConfig(**kw, oma=toma.OMAConfig(eta=0.05, rounding=rounding)))


@pytest.fixture(scope="module")
def rolling():
    params = dict(jtrace.TINY_TRACE_KWARGS["rolling_catalog"])
    catalog, reqs, _ = jtrace.build_trace("rolling_catalog", **params)
    events = jtrace.rolling_catalog_events(**params)
    return params, catalog, reqs, events


def caches(catalog, n0, index, rounding="depround"):
    jcfg, tcfg = _cfgs(rounding)
    jc = jpol.AcaiCache(jnp.asarray(catalog[:n0]),
                        dataclasses.replace(jcfg, index=None if index is None
                                            else JSpec(index, IVF)), seed=0)
    tspec = None if index is None else IndexSpec(index, {**IVF, "init_fn": jinit(0)})
    tc = tpol.AcaiCache(catalog[:n0], dataclasses.replace(tcfg, index=tspec), seed=0,
                        device="cpu")
    tc.state = convert.cache_state_from_numpy(jc.state.y, jc.state.x, 0, device="cpu")
    return jc, tc, RefUniforms(jc.state.key, rounding)


def check_replay(got, want, k, c_f):
    np.testing.assert_allclose(got["gain"], want["gain"], rtol=RTOL, atol=1e-5 * k * c_f)
    for key in ("served_local", "fetched", "occupancy"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    for key in ("events_applied", "compactions", "requests"):
        assert got[key] == want[key], key
    nag = lambda r: float(np.sum(r["gain"])) / (k * c_f * r["requests"])  # noqa: E731
    assert abs(nag(got) - nag(want)) < 1e-3


def check_caches(jc, tc):
    np.testing.assert_allclose(tc.state.y.numpy(), np.asarray(jc.state.y), rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_array_equal(tc.state.x.numpy(), np.asarray(jc.state.x))
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    assert tc.live_count == jc.live_count and tc.catalog.shape == jc.catalog.shape


@pytest.mark.parametrize("index,refresh_every,compact_every", [
    (None, 0, 0), (None, 0, 24), ("ivf", 0, 0), ("ivf", 32, 0), ("ivf", 16, 24)])
def test_replay_with_churn_matches_reference(rolling, index, refresh_every, compact_every):
    """AÇAI under churn, exact and over IVF, with the two-phase refresh and
    compaction: 60 requests (a tail of events lands past the last full
    mini-batch and is drained)."""
    params, catalog, reqs, events = rolling
    n0 = jchurn.warm_size(params["n"], params["warm"])
    jc, tc, us = caches(catalog, n0, index)
    kw = dict(batch=8, refresh_every=refresh_every, compact_every=compact_every)
    want = jchurn.replay_with_churn(jc, catalog, reqs[:60], events, **kw)
    got = tchurn.replay_with_churn(tc, catalog, reqs[:60], events, uniforms_fn=us, **kw)
    check_replay(got, want, 4, 1.0)
    check_caches(jc, tc)
    assert got["events_applied"] == len(events) and got["requests"] == 56
    assert tc.live_count == n0
    if compact_every:
        assert got["compactions"] >= 1 and tc.catalog.shape[0] == tc.state.y.shape[0]
    if index is not None:
        np.testing.assert_array_equal(tc.index.invlists.numpy(),
                                      np.asarray(jc.index.invlists))
    for key in ("mutation_s", "mutation_device_s", "mutation_host_s", "refresh_s",
                "refresh_stall_s", "compact_s", "p50_step_s"):
        assert got[key] >= 0.0
    assert got["refresh_stall_s"] <= got["refresh_s"]


def test_replay_with_churn_policy_and_baseline_match_reference(rolling):
    """The replay over the registry: AcaiPolicy (coupled rounding) and
    SIM-LRU (its online oracle), each against the reference's."""
    params, catalog, reqs, events = rolling
    n0 = jchurn.warm_size(params["n"], params["warm"])
    spec = {"h": 24, "k": 4, "c_remote": 16, "c_local": 8, "eta": 0.05, "batch": 8}
    jp = JPA.build_policy(JPA.PolicySpec("acai", spec), catalog[:n0], JCostModel(c_f=1.0),
                          seed=0)
    tp = TPA.build_policy(TPA.PolicySpec("acai", spec), catalog[:n0], CostModel(c_f=1.0),
                          seed=0, device="cpu")
    st = jp.cache.state
    tp.cache.state = convert.cache_state_from_numpy(st.y, st.x, 0, device="cpu")
    us = RefUniforms(st.key, "coupled")
    want = jchurn.replay_with_churn(jp, catalog, reqs, events, batch=8, compact_every=32)
    got = tchurn.replay_with_churn(tp, catalog, reqs, events, batch=8, compact_every=32,
                                   uniforms_fn=us)
    check_replay(got, want, 4, 1.0)
    assert tp.live_count == jp.cache.live_count == n0
    # a mutated AcaiPolicy replays through its own steps
    assert TPA.replay_trace(tp, reqs[:16], batch=8)["requests"] == 16

    kw = dict(JPA.TINY_POLICY_KWARGS["sim_lru"])
    jb = JPA.build_policy(JPA.PolicySpec("sim_lru", kw), catalog[:n0], JCostModel(c_f=1.0),
                          seed=0)
    tb = TPA.build_policy(TPA.PolicySpec("sim_lru", kw), catalog[:n0], CostModel(c_f=1.0),
                          seed=0, device="cpu")
    want = jchurn.replay_with_churn(jb, catalog, reqs, events, batch=8, compact_every=32)
    got = tchurn.replay_with_churn(tb, catalog, reqs, events, batch=8, compact_every=32)
    check_replay(got, want, 4, 1.0)
    assert got["compactions"] >= 1
    np.testing.assert_array_equal(np.sort(tb.policy.cached_object_ids()),
                                  np.sort(jb.policy.cached_object_ids()))


def test_churn_zero_is_the_static_replay(rolling):
    """At churn 0 the schedule is empty, the cache never leaves its static
    step, and the replay equals make_replay_batched on the warm window
    (and the reference's replay)."""
    params, _, _, _ = rolling
    params = dict(params, churn_rate=0.0)
    catalog, reqs, _ = jtrace.build_trace("rolling_catalog", **params)
    events = jtrace.rolling_catalog_events(**params)
    assert events == []
    n0 = jchurn.warm_size(params["n"], params["warm"])
    jc, tc, us = caches(catalog, n0, None)
    state0 = tpol.copy_state(tc.state)
    got = tchurn.replay_with_churn(tc, catalog, reqs, events, batch=8, uniforms_fn=us)
    assert got["events_applied"] == 0 and not tc._mutated
    _, tcfg = _cfgs()
    replay = tpol.make_replay_batched(tcfg, tpol.exact_candidate_fn_batched(
        _t(catalog[:n0]), tcfg.c_remote, tcfg.c_local), 8)
    uniforms = torch.from_numpy(np.stack([us(i, n0) for i in range(len(reqs) // 8)]))
    st, m = replay(state0, _t(reqs), uniforms)
    np.testing.assert_array_equal(got["gain"], m.gain_int.numpy())
    np.testing.assert_array_equal(got["served_local"], m.served_local.numpy())
    np.testing.assert_array_equal(got["occupancy"], m.occupancy.numpy())
    assert torch.equal(tc.state.y, st.y) and torch.equal(tc.state.x, st.x)
    want = jchurn.replay_with_churn(jc, catalog, reqs, events, batch=8)
    check_replay(got, want, 4, 1.0)


def test_churn_replay_checks_the_schedule(rolling):
    """A policy built on the wrong catalog slice misaligns the ids: loud."""
    params, catalog, reqs, events = rolling
    n0 = jchurn.warm_size(params["n"], params["warm"])
    _, tcfg = _cfgs()
    tc = tpol.AcaiCache(catalog[:n0 - 1], tcfg, seed=0, device="cpu")
    with pytest.raises(AssertionError, match="misalignment"):
        tchurn.replay_with_churn(tc, catalog, reqs, events, batch=8)
    with pytest.raises(ValueError, match="shorter than one mini-batch"):
        tchurn.replay_with_churn(tc, catalog, reqs[:4], events, batch=8)


# ---------------------------------------------------------------------------
# the semantic tier and the launcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    from repro.configs import SMOKE_ARCHS as J_SMOKE
    from repro.models import init_params as j_init_params
    from repro_torch.models.config import ModelConfig

    jcfg = dataclasses.replace(J_SMOKE["qwen1.5-0.5b"], dtype="float32")
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    port = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, port


def test_semantic_tier_mutation_matches_reference(lm):
    """add_documents / remove_documents / compact: ids, the payload table
    and what is served afterwards equal the reference's."""
    from repro.serve import SemanticCachedLM as JSemantic
    from repro_torch.serve import SemanticCachedLM as TSemantic

    jcfg, jparams, tcfg, port = lm
    rng = np.random.default_rng(3)
    n = 120
    cat = rng.normal(size=(n + 20, jcfg.d_model)).astype(np.float32)
    cat /= np.linalg.norm(cat, axis=1, keepdims=True)
    prompts = [rng.integers(0, 24, 10).astype(np.int32) for _ in range(10)]
    kw = dict(h=16, k=4, c_f=0.5)
    jlm = JSemantic(jparams, jcfg, jnp.array(cat[:n]), list(range(n)), lambda p: None, **kw)
    tlm = TSemantic(port, tcfg, cat[:n], list(range(n)), lambda p: None, **kw)
    st = jlm.cache.state
    tlm.cache.state = convert.cache_state_from_numpy(st.y, st.x, 0, device="cpu")
    us = RefUniforms(st.key, jlm.cache.cfg.oma.rounding)
    step = 0

    def serve(ps):
        nonlocal step
        for p in ps:
            jm = jlm.query(jnp.array(p))
            tm = tlm.query(_t(p), _t(us(step, tlm.cache.state.y.shape[0])))
            step += 1
            assert int(tm.served_local) == int(jm.served_local)

    serve(prompts[:4])
    new = [f"doc-{i}" for i in range(20)]
    assert tlm.add_documents(cat[n:], new) == jlm.add_documents(jnp.array(cat[n:]), new)
    tlm.remove_documents([0, 5, n + 3])
    jlm.remove_documents([0, 5, n + 3])
    assert tlm.payloads == jlm.payloads
    serve(prompts[4:7])
    tlm.compact()
    jlm.compact()
    assert tlm.payloads == jlm.payloads and len(tlm.payloads) == n + 20 - 3
    serve(prompts[7:])
    check_caches(jlm.cache, tlm.cache)
    assert abs(tlm.nag - jlm.nag) < 1e-3
    with pytest.raises(ValueError, match="payloads"):
        tlm.add_documents(cat[:2], ["one"])


def test_launcher_churn_on_the_cpu():
    """`--churn-rate` at SMOKE size: the rolling window's events fire before
    the requests they precede, over an exact and an IVF tier; a mesh and
    bad rates are refused."""
    from repro_torch.launch import serve

    for index in (["--remote-index", "exact"],
                  ["--remote-index", "ivf", "--index-opt", "nlist=4", "--index-opt",
                   "nprobe=2"]):
        fig = serve.main(["--smoke", "--device", "cpu", "--requests", "8", "--batch", "4",
                          "--query-batches", "2", "--catalog", "64", "--churn-rate", "0.5",
                          "--churn-warm", "0.5", *index])
        sem = fig["semantic"]
        assert sem["requests"] == 16 and sem["churn_events"] == 8 and sem["warm"] == 32
        assert sem["mutation_s"] > 0 and 0.0 <= sem["nag"] <= 1.0
    fig = serve.main(["--smoke", "--device", "cpu", "--requests", "4", "--batch", "4",
                      "--catalog", "32"])
    assert fig["semantic"]["churn_events"] == 0 and fig["semantic"]["warm"] == 32
    with pytest.raises(SystemExit, match="exact masked scan"):
        serve.main(["--smoke", "--device", "cpu", "--mesh-shards", "2",
                    "--churn-rate", "0.1", "--remote-index", "ivf_sharded"])
    with pytest.raises(SystemExit, match="churn"):
        serve.main(["--smoke", "--device", "cpu", "--churn-rate", "-1"])
