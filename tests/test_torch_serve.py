"""Port parity of the LM serving tier: `repro_torch.serve` against
`repro.serve` at SMOKE size in float32, on the reference's parameters
(carried in by `convert.lm_params_from_numpy`).

Discrete outputs must be equal: greedy tokens of `generate`, the
`ServeEngine`'s finished sequences, and the semantic tier's served-local
count per request.  `embed_prompt` agrees to 1e-6; the semantic tier's
NAG to 1e-3, with the reference's initial cache state and its rounding
uniforms carried in (drawn as tests/test_torch_policy.py draws them).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.core.costs import calibrate_fetch_cost as j_calibrate
from repro.models import init_params as j_init_params
from repro.serve import SemanticCachedLM as JSemantic
from repro.serve import ServeEngine as JEngine
from repro.serve import embed_prompt as j_embed_prompt
from repro.serve import generate as j_generate
from repro_torch import convert
from repro_torch.models.config import ModelConfig
from repro_torch.serve import SemanticCachedLM as TSemantic
from repro_torch.serve import ServeEngine as TEngine
from repro_torch.serve import embed_prompt as t_embed_prompt
from repro_torch.serve import generate as t_generate
from repro_torch.serve.remote import FaultSpec, FaultyRemote


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def lm():
    """float32 qwen1.5-0.5b SMOKE: (reference cfg, reference params, port
    cfg, port model)."""
    jcfg = dataclasses.replace(J_SMOKE["qwen1.5-0.5b"], dtype="float32")
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    return jcfg, jparams, tcfg, convert.lm_params_from_numpy(np_params, tcfg, device="cpu")


def reference_uniforms(key, n: int, steps: int) -> np.ndarray:
    """(steps, n) coupled-rounding uniforms, as the reference draws them:
    key, k_round = split(key) per step, uniform(k_round, (n,))."""
    out = np.empty((steps, n), np.float32)
    for i in range(steps):
        key, k_round = jax.random.split(key)
        out[i] = np.asarray(jax.random.uniform(k_round, (n,), dtype=jnp.float32))
    return out


@pytest.mark.parametrize("b,s,steps,s_max", [(2, 8, 6, None), (1, 8, 5, None),
                                             (3, 5, 4, 24)])
def test_generate_greedy_tokens_match_reference(lm, b, s, steps, s_max):
    jcfg, jparams, tcfg, port = lm
    prompt = np.random.default_rng(s + b).integers(0, jcfg.vocab, (b, s)).astype(np.int32)
    want = j_generate(jparams, jcfg, jnp.array(prompt), steps=steps, s_max=s_max)
    got = t_generate(port, tcfg, _t(prompt), steps=steps, s_max=s_max)
    assert got.shape == (b, steps) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_temperature_sampling_is_seeded_and_greedy_at_zero(lm):
    _, _, tcfg, port = lm
    prompt = torch.randint(0, tcfg.vocab, (2, 6), generator=torch.Generator().manual_seed(0))
    a = t_generate(port, tcfg, prompt, steps=5, temperature=1.0, seed=3)
    b = t_generate(port, tcfg, prompt, steps=5, temperature=1.0, seed=3)
    assert torch.equal(a, b)
    greedy = t_generate(port, tcfg, prompt, steps=5)
    # uniforms of exactly 1 - 2^-24 give almost no noise: the greedy tokens
    u = torch.full((4, 2, tcfg.vocab), 1.0 - 2.0 ** -24)
    assert torch.equal(t_generate(port, tcfg, prompt, steps=5, temperature=1e-3,
                                  uniforms=u), greedy)


@pytest.mark.parametrize("batch,n_req,prompt_len,max_tokens,seed", [
    (3, 7, 8, 4, 0),   # tests/test_serve.py: continuous batching completes all
    (2, 5, 6, 2, 1),   # tests/test_serve.py: FIFO admission with slot reuse
])
def test_serve_engine_matches_reference(lm, batch, n_req, prompt_len, max_tokens, seed):
    jcfg, jparams, tcfg, port = lm
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, jcfg.vocab, prompt_len).astype(np.int32)
               for _ in range(n_req)]
    jeng = JEngine(jparams, jcfg, batch=batch, s_max=32)
    teng = TEngine(port, tcfg, batch=batch, s_max=32)
    for i, p in enumerate(prompts):
        jeng.submit(i, jnp.asarray(p), max_tokens=max_tokens)
        teng.submit(i, _t(p), max_tokens=max_tokens)
    # first admission wave: FIFO into every free slot, none while all are busy
    assert teng._admit() == jeng._admit() == batch
    assert [s.request_id for s in teng.slots] == list(range(batch))
    assert teng._admit() == 0
    steps = 0
    while teng.step():
        steps += 1
        assert jeng.step()
    assert not jeng.step()
    assert sorted(teng.done) == list(range(n_req))
    assert not any(s.active for s in teng.slots)
    assert teng._admit() == 0
    assert {k: list(map(int, v)) for k, v in teng.done.items()} == \
        {k: list(map(int, v)) for k, v in jeng.done.items()}


def test_embed_prompt_matches_reference(lm):
    jcfg, jparams, _, port = lm
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, 11).astype(np.int32)
    np.testing.assert_allclose(t_embed_prompt(port, _t(toks)).numpy(),
                               np.asarray(j_embed_prompt(jparams, jnp.array(toks))),
                               rtol=1e-6, atol=1e-6)
    batch = rng.integers(0, jcfg.vocab, (4, 9)).astype(np.int32)
    want = np.stack([np.asarray(j_embed_prompt(jparams, jnp.array(r))) for r in batch])
    np.testing.assert_allclose(t_embed_prompt(port, _t(batch)).numpy(), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("index", [None, "flat"])
def test_semantic_cached_lm_matches_reference(lm, index):
    """12 single queries, then batches of 4 (equal and unequal prompt
    lengths), generation counted on both sides."""
    jcfg, jparams, tcfg, port = lm
    rng = np.random.default_rng(7)
    n, h, k = 300, 16, 4
    cat = rng.normal(size=(n, jcfg.d_model)).astype(np.float32)
    cat /= np.linalg.norm(cat, axis=1, keepdims=True)
    # prompts over a small vocabulary slice, so that requests repeat and
    # the cache has something to learn
    singles = [rng.integers(0, 24, 10).astype(np.int32) for _ in range(12)]
    batches = [[rng.integers(0, 24, 10).astype(np.int32) for _ in range(4)]
               for _ in range(2)]
    batches.append([rng.integers(0, 24, n_).astype(np.int32) for n_ in (6, 9, 10, 12)])
    c_f = float(j_calibrate(jnp.array(cat), kth=50))
    gens = {"ref": 0, "port": 0}

    def counter(side):
        def fn(_prompt):
            gens[side] += 1
        return fn

    jlm = JSemantic(jparams, jcfg, jnp.array(cat), list(range(n)), counter("ref"),
                    h=h, k=k, c_f=c_f, index_spec=index)
    tlm = TSemantic(port, tcfg, cat, list(range(n)), counter("port"), h=h, k=k,
                    c_f=c_f, index_spec=index)
    jstate = jlm.cache.state
    tlm.cache.state = convert.cache_state_from_numpy(jstate.y, jstate.x, int(jstate.t),
                                                     device="cpu")
    us = reference_uniforms(jstate.key, n, len(singles) + len(batches))
    for i, p in enumerate(singles):
        jm = jlm.query(jnp.array(p))
        tm = tlm.query(_t(p), _t(us[i]))
        assert int(tm.served_local) == int(jm.served_local)
    for i, ps in enumerate(batches):
        jm = jlm.query_batch([jnp.array(p) for p in ps])
        tm = tlm.query_batch([_t(p) for p in ps], _t(us[len(singles) + i]))
        np.testing.assert_array_equal(tm.served_local.numpy(), np.asarray(jm.served_local))
    assert tlm.stats.requests == jlm.stats.requests == 24
    assert tlm.stats.served_local == jlm.stats.served_local
    assert gens["port"] == gens["ref"] == tlm.stats.generated == jlm.stats.generated
    assert abs(tlm.nag - jlm.nag) < 1e-3
    assert tlm.stats.served_local > 0


@pytest.mark.parametrize("policy_spec", ["sim_lru", {"policy": "qcache", "h": 24},
                                         {"policy": "cls_lru", "k_prime": 8,
                                          "augmented": True}])
def test_semantic_cached_lm_baseline_matches_reference(lm, policy_spec):
    """A baseline as the semantic tier (its online oracle answering each
    step): served_local per request and the generations equal the
    reference's on the same weights, NAG to 1e-5.  The catalog holds the
    embeddings of a pool of prompts that the requests repeat."""
    jcfg, jparams, tcfg, port = lm
    rng = np.random.default_rng(11)
    pool = [rng.integers(0, jcfg.vocab, 10).astype(np.int32) for _ in range(60)]
    extra = rng.normal(size=(140, jcfg.d_model)).astype(np.float32)
    extra /= np.linalg.norm(extra, axis=1, keepdims=True)
    cat = np.concatenate([np.stack([np.asarray(j_embed_prompt(jparams, jnp.array(p)))
                                    for p in pool]), extra])
    n, c_f = cat.shape[0], 0.05
    picks = rng.integers(0, 20, 28)
    singles = [pool[i] for i in picks[:12]]
    batches = [[pool[i] for i in picks[j:j + 4]] for j in range(12, 28, 4)]
    gens = {"ref": 0, "port": 0}

    def counter(side):
        def fn(_prompt):
            gens[side] += 1
        return fn

    jlm = JSemantic(jparams, jcfg, jnp.array(cat), list(range(n)), counter("ref"),
                    h=16, k=4, c_f=c_f, policy_spec=policy_spec)
    tlm = TSemantic(port, tcfg, cat, list(range(n)), counter("port"), h=16, k=4,
                    c_f=c_f, policy_spec=policy_spec)
    assert tlm.policy_spec == tlm.policy.spec and tlm.cache is None
    assert tlm.policy_spec.to_dict() == jlm.policy_spec.to_dict()
    for p in singles:
        assert int(tlm.query(_t(p)).served_local) == int(jlm.query(jnp.array(p)).served_local)
    for ps in batches:
        tm = tlm.query_batch([_t(p) for p in ps])
        jm = jlm.query_batch([jnp.array(p) for p in ps])
        np.testing.assert_array_equal(tm.served_local.numpy(), np.asarray(jm.served_local))
    assert tlm.stats.served_local == jlm.stats.served_local > 0
    assert gens["port"] == gens["ref"] == tlm.stats.generated
    assert abs(tlm.nag - jlm.nag) < 1e-5
    with pytest.raises(ValueError, match="index_spec"):
        TSemantic(port, tcfg, cat, list(range(n)), lambda p: None, h=16, k=4, c_f=c_f,
                  policy_spec=policy_spec, index_spec="flat")
    with pytest.raises(ValueError, match="eta only applies"):
        TSemantic(port, tcfg, cat, list(range(n)), lambda p: None, h=16, k=4, c_f=c_f,
                  policy_spec=policy_spec, eta=0.1)


def test_semantic_cached_lm_refuses_what_is_not_ported(lm):
    _, _, tcfg, port = lm
    cat = np.eye(8, tcfg.d_model, dtype=np.float32)
    kw = dict(h=2, k=1, c_f=1.0)
    with pytest.raises(NotImplementedError, match="A11"):
        TSemantic(port, tcfg, cat, list(range(8)), lambda p: None, **kw, mesh=object())
    # the remote / resilience tiers and the answer cache are ported
    # (test_semantic_tier_resilience_and_answer_cache_match_reference); the
    # answer cache needs an index, as in the reference
    with pytest.raises(ValueError, match="cfg.index"):
        TSemantic(port, tcfg, cat, list(range(8)), lambda p: None, **kw, answer_cache=8)
    res = TSemantic(port, tcfg, cat, list(range(8)), lambda p: None, **kw,
                    remote=FaultyRemote(FaultSpec(error_rate=0.5)))
    assert res.policy.session.remote.spec.error_rate == 0.5
    # the catalog mutates online (tests/test_torch_churn.py holds it to the
    # reference)
    tlm = TSemantic(port, tcfg, cat, list(range(8)), lambda p: None, **kw)
    assert tlm.add_documents(cat[:1], ["x"]) == [8]
    tlm.remove_documents([0])
    tlm.compact()
    assert tlm.payloads == list(range(1, 8)) + ["x"]


def test_semantic_traffic_repeats_catalog_prompts_with_zipf_popularity(lm):
    """The launcher's semantic traffic (the paper's IRM): every request
    repeats a catalog object's prompt, so its embedding is that row, and
    the object of barycentric rank r is requested with Zipf(0.9)
    probability r^-0.9 / H (checked on the top ten ranks to 5 sigma)."""
    from repro_torch.launch.serve import ZIPF_A, semantic_traffic

    _, _, tcfg, port = lm
    n, t = 200, 20000
    cat, prompts, ids = semantic_traffic(port, tcfg, n, 8, t, np.random.default_rng(0), "cpu")
    assert cat.shape == (n, tcfg.d_model) and len(prompts) == t
    for j in range(0, t, 997):
        np.testing.assert_allclose(t_embed_prompt(port, prompts[j]).numpy(),
                                   cat[ids[j]].numpy(), rtol=1e-6, atol=1e-6)
    c = cat.numpy().astype(np.float64)
    order = np.argsort(np.linalg.norm(c - c.mean(axis=0), axis=1))
    p = np.arange(1, n + 1) ** -ZIPF_A
    p /= p.sum()
    freq = np.bincount(ids, minlength=n)[order] / t
    assert np.all(np.abs(freq[:10] - p[:10]) < 5 * np.sqrt(p[:10] / t))


@pytest.mark.parametrize("index", ["exact", "flat"])
def test_launcher_serves_both_tiers_on_the_cpu(index):
    """`main` at SMOKE size: every engine request prefills once with finite
    logits, and the semantic tier's figures add up."""
    from repro_torch.launch import serve

    fig = serve.main(["--smoke", "--device", "cpu", "--requests", "8", "--batch", "4",
                      "--query-batches", "2", "--catalog", "256",
                      "--remote-index", index])
    eng, sem = fig["engine"], fig["semantic"]
    assert eng["requests"] == eng["prefills"] == 8 and eng["logits_finite"]
    assert eng["decode_tokens"] == eng["tokens"] - 8
    assert sem["requests"] == 16 and 0 < sem["distinct_objects"] <= 16
    assert sem["generate_share"] == sem["generations"] / 16
    assert 0 <= sem["served_local"] <= sem["objects"] == 64
    assert sem["us_per_request"] >= sem["us_per_request_without_generation"] > 0
    assert 0.0 <= sem["nag"] <= 1.0


@pytest.mark.parametrize("policy", ["acai", "lru", "sim_lru", "cls_lru", "rnd_lru", "qcache"])
def test_launcher_serves_every_registered_policy_on_the_cpu(policy):
    """`--policy` / `--policy-opt` at SMOKE size, for every registered
    policy; a baseline refuses `--remote-index`."""
    from repro_torch.core.policy_api import registered_policies
    from repro_torch.launch import serve

    assert policy in registered_policies()
    opts = ["--policy-opt", "k_prime=8"] if policy in ("sim_lru", "cls_lru", "rnd_lru") else []
    fig = serve.main(["--smoke", "--device", "cpu", "--requests", "4", "--batch", "4",
                      "--query-batches", "1", "--catalog", "128", "--policy", policy, *opts])
    sem = fig["semantic"]
    assert sem["policy"]["policy"] == policy and sem["requests"] == 8
    if opts:
        assert sem["policy"]["k_prime"] == 8
    assert 0.0 <= sem["nag"] <= 1.0 and sem["c_f"] > 0
    if policy != "acai":
        with pytest.raises(SystemExit, match="only applies to acai"):
            serve.main(["--smoke", "--device", "cpu", "--policy", policy,
                        "--remote-index", "flat"])
    with pytest.raises(SystemExit, match="--policy-opt"):
        serve.main(["--smoke", "--device", "cpu", "--policy", policy, "--policy-opt", "x"])


SEMANTIC_TIERS = [
    ("answer cache", dict(index_spec="flat", answer_cache=64)),
    ("resilient acai", dict(index_spec="flat", answer_cache=64, fault=dict(
        error_rate=0.3, outages=((6, 14),), seed=3), resilience=dict(deadline_ms=60.0))),
    ("resilient sim_lru", dict(policy_spec={"policy": "sim_lru", "k_prime": 8},
                               fault=dict(error_rate=0.4, seed=1), resilience={})),
]


@pytest.mark.parametrize("case", range(len(SEMANTIC_TIERS)))
def test_semantic_tier_resilience_and_answer_cache_match_reference(lm, case):
    """The semantic tier with `answer_cache=`, `remote=` / `resilience=`
    against the reference's SemanticCachedLM at SMOKE size (AÇAI fed the
    reference's uniforms): served_local per request, generations, the
    answer tier's statistics and the resilience counters exactly, NAG to
    1e-5.  The requests repeat a pool of prompts, so answers repeat."""
    from repro.serve import remote as JR
    from repro.serve import resilience as JRes
    from repro_torch.serve.resilience import ResilienceConfig

    _, kw = SEMANTIC_TIERS[case]
    kw = dict(kw)
    jcfg, jparams, tcfg, port = lm
    rng = np.random.default_rng(5)
    pool = [rng.integers(0, jcfg.vocab, 10).astype(np.int32) for _ in range(24)]
    extra = rng.normal(size=(120, jcfg.d_model)).astype(np.float32)
    extra /= np.linalg.norm(extra, axis=1, keepdims=True)
    cat = np.concatenate([np.stack([np.asarray(j_embed_prompt(jparams, jnp.array(p)))
                                    for p in pool]), extra])
    n, c_f = cat.shape[0], 0.05
    picks = rng.integers(0, 12, 36)
    singles = [pool[i] for i in picks[:20]]
    batches = [[pool[i] for i in picks[j:j + 4]] for j in range(20, 36, 4)]
    fault, res_kw = kw.pop("fault", None), kw.pop("resilience", None)
    jkw, tkw = dict(kw), dict(kw)
    if fault is not None:
        jkw.update(remote=JR.FaultyRemote(JR.FaultSpec(**fault)),
                   resilience=JRes.ResilienceConfig(**res_kw))
        tkw.update(remote=FaultyRemote(FaultSpec(**fault)),
                   resilience=ResilienceConfig(**res_kw))
    jlm = JSemantic(jparams, jcfg, jnp.array(cat), list(range(n)), lambda p: None,
                    h=16, k=4, c_f=c_f, **jkw)
    tlm = TSemantic(port, tcfg, cat, list(range(n)), lambda p: None, h=16, k=4,
                    c_f=c_f, **tkw)
    us = [None] * (len(singles) + len(batches))
    if tlm.cache is not None:
        jstate = jlm.cache.state
        tlm.cache.state = convert.cache_state_from_numpy(jstate.y, jstate.x,
                                                         int(jstate.t), device="cpu")
        us = [_t(u) for u in reference_uniforms(jstate.key, n, len(us))]
    for i, p in enumerate(singles):
        assert int(tlm.query(_t(p), us[i]).served_local) == int(
            jlm.query(jnp.array(p)).served_local)
    for i, ps in enumerate(batches):
        tm = tlm.query_batch([_t(p) for p in ps], us[len(singles) + i])
        jm = jlm.query_batch([jnp.array(p) for p in ps])
        np.testing.assert_array_equal(tm.served_local.numpy(), np.asarray(jm.served_local))
    assert tlm.stats.served_local == jlm.stats.served_local
    assert tlm.stats.generated == jlm.stats.generated
    assert abs(tlm.nag - jlm.nag) < 1e-5
    if "answer_cache" in kw:
        got, want = tlm.answer_cache.stats(), jlm.answer_cache.stats()
        assert {k: got[k] for k in want} == want and got["hits"] > 0
    if fault is not None:
        assert tlm.policy.session.counters.to_dict() == jlm.policy.session.counters.to_dict()
        assert tlm.policy.session.breaker.log == jlm.policy.session.breaker.log
        assert tlm.policy.session.counters.remote_failures > 0


LAUNCHER_FLAGS = [
    ["--remote-index", "flat", "--answer-cache", "64"],
    ["--remote-index", "ivf", "--index-opt", "nlist=8", "--answer-cache", "32",
     "--answer-cache-opt", "hit_ms=0.1", "--answer-cache-opt", "idle_unload_ms=5"],
    ["--remote-index", "flat", "--answer-cache", "0"],
    ["--remote-index", "flat", "--answer-cache", "64", "--churn-rate", "0.2"],
    ["--remote-fault-rate", "0.3", "--deadline-ms", "250"],
    ["--remote-fault-outage", "2:6", "--policy", "sim_lru", "--policy-opt", "k_prime=8"],
    ["--remote-fault-latency-ms", "40", "--hedge-ms", "30", "--retries", "3",
     "--remote-fault-corrupt", "0.2", "--remote-fault-seed", "4"],
    ["--arrival", "poisson", "--offered-load", "0.8", "--batch-window-ms", "5",
     "--slo-ms", "25", "--remote-index", "flat", "--answer-cache", "64"],
    ["--arrival", "flash_crowd", "--offered-load", "1.2", "--queue-cap", "4",
     "--arrival-seed", "3"],
    ["--arrival", "closed_loop", "--slo-ms", "25", "--shed-deadline-ms", "6",
     "--batch-window-ms", "0"],
]


@pytest.mark.parametrize("flags", LAUNCHER_FLAGS, ids=lambda f: " ".join(f[:2]))
def test_launcher_a9_flags_on_the_cpu(flags):
    """Every answer-cache, resilience and online-serving flag at SMOKE size
    on the CPU: the tier it names runs and reports."""
    from repro_torch.launch import serve

    fig = serve.main(["--smoke", "--device", "cpu", "--requests", "16", "--batch", "4",
                      "--catalog", "128", "--max-tokens", "2", *flags])
    sem = fig["semantic"]
    assert sem["requests"] == 16 and 0.0 <= sem["nag"] <= 1.0
    if "--answer-cache" in flags:
        st = sem["answer_cache"]
        assert st["capacity"] == int(flags[flags.index("--answer-cache") + 1])
        assert st["hits"] + st["misses"] > 0 or st["capacity"] == 0
        if "--churn-rate" in flags:
            assert sem["churn_events"] > 0
    if any(f.startswith("--remote-fault") or f in ("--deadline-ms", "--hedge-ms",
                                                    "--retries") for f in flags):
        assert sem["resilience"]["requests"] == 16
    if "--arrival" in flags:
        on = sem["online"]
        assert on["requests"] == 16 and on["served"] + on["shed_total"] == 16
        assert 0.0 <= on["nag"] <= 1.0
        if "--slo-ms" in flags:
            assert 0.0 <= on["goodput_slo"] <= 1.0


@pytest.mark.parametrize("flags,msg", [
    (["--answer-cache", "64"], "--remote-index"),
    (["--answer-cache", "64", "--churn-rate", "0.2"], "--remote-index"),
    (["--answer-cache-opt", "hit_ms=1"], "--answer-cache-opt needs --answer-cache"),
    (["--answer-cache", "8", "--remote-index", "flat", "--answer-cache-opt", "hit_ms"],
     "KEY=VALUE"),
    (["--answer-cache", "8", "--remote-index", "flat", "--answer-cache-opt", "cap=1"],
     "unknown fields|unexpected keyword"),
    (["--answer-cache", "-1", "--remote-index", "flat"], "capacity"),
    (["--answer-cache", "8", "--policy", "lru"], "oracle-exact"),
    (["--index-opt", "nlist=8"], "--index-opt needs --remote-index"),
    (["--remote-fault-rate", "1.5"], "error_rate"),
    (["--remote-fault-outage", "9:3"], "outage window"),
    (["--mesh-shards", "2"], "A11"),
])
def test_launcher_a9_validation_errors(flags, msg):
    """The reference's validation errors, raised before any model is built."""
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match=msg):
        serve.main(["--smoke", "--device", "cpu", "--requests", "4", "--catalog", "64",
                    *flags])
