"""Port parity, the slice as a whole: the batched AÇAI step of repro_torch
against repro.core.policy, with exact, flat and IVF candidates.

The reference splits its state key once per step and draws the rounding
uniforms from `k_round` (policy.py apply_candidates_batched); the helper
below draws the same numbers in JAX and injects them into the port, which
never sees a key.  Tolerances: gains and y agree to rtol 1e-5 and atol
1e-5 x their scale (k * c_f for gains); served_local and x must be equal.
On the BENCH_pipeline sift cell the port's NAG equals the reference's to
1e-3 over the whole 2048-request replay.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import oma as joma
from repro.core import policy as jpol
from repro.core import trace as jtrace
from repro.core.costs import calibrate_fetch_cost as j_calibrate
from repro.index import candidates as jcand
from repro.index.exact import FlatIndex as JFlat
from repro.index.ivf import IVFFlatIndex as JIVF
from repro_torch import convert
from repro_torch.core import oma as toma
from repro_torch.core import policy as tpol
from repro_torch.index import candidates as tcand
from repro_torch.index.base import IndexSpec
from repro_torch.index.exact import FlatIndex as TFlat

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def reference_uniforms(key, n: int, steps: int) -> np.ndarray:
    """(steps, n) coupled-rounding uniforms, as the reference draws them:
    key, k_round = split(key) per step, uniform(k_round, (n,))."""
    out = np.empty((steps, n), np.float32)
    for i in range(steps):
        key, k_round = jax.random.split(key)
        out[i] = np.asarray(jax.random.uniform(k_round, (n,), dtype=jnp.float32))
    return out


def _configs(c_f, h=48, k=8):
    jcfg = jpol.AcaiConfig(h=h, k=k, c_f=c_f, c_remote=32, c_local=16,
                           oma=joma.OMAConfig(eta=0.05 / c_f))
    tcfg = tpol.AcaiConfig(h=h, k=k, c_f=c_f, c_remote=32, c_local=16,
                           oma=toma.OMAConfig(eta=0.05 / c_f))
    return jcfg, tcfg


def _candidate_fns(kind, cat):
    if kind == "exact":
        return (jpol.exact_candidate_fn_batched(jnp.array(cat), 32, 16),
                tpol.exact_candidate_fn_batched(_t(cat), 32, 16))
    if kind == "flat":
        return (jcand.index_candidate_fn_batched(JFlat(jnp.array(cat), kernel="xla"),
                                                 jnp.array(cat), 32, 16, h=48),
                tcand.index_candidate_fn_batched(TFlat(cat, device="cpu"), _t(cat),
                                                 32, 16, h=48))
    ref = JIVF(jnp.array(cat), nlist=16, nprobe=4, train_iters=4)
    port = convert.ivf_from_numpy(cat, np.asarray(ref.centroids),
                                  np.asarray(ref.invlists), 4, device="cpu")
    return (jcand.index_candidate_fn_batched(ref, jnp.array(cat), 32, 16, h=48),
            tcand.index_candidate_fn_batched(port, _t(cat), 32, 16, h=48))


@pytest.mark.parametrize("kind", ["exact", "flat", "ivf"])
@pytest.mark.parametrize("b", [1, 8])
def test_batched_step_matches_reference_per_step(kind, b):
    cat, reqs, _ = jtrace.sift_like(n=800, d=16, t=8 * 6, seed=2)
    c_f = 0.5
    jcfg, tcfg = _configs(c_f)
    jfn, tfn = _candidate_fns(kind, cat)
    jstep = jax.jit(jpol.make_step_batched(jcfg, jfn, b))
    tstep = tpol.make_step_batched(tcfg, tfn, b)
    jstate = jpol.init_state(cat.shape[0], jcfg, seed=0)
    tstate = convert.cache_state_from_numpy(jstate.y, jstate.x, int(jstate.t),
                                            device="cpu")
    steps = 4
    us = reference_uniforms(jstate.key, cat.shape[0], steps)
    for i in range(steps):
        rs = reqs[i * b:(i + 1) * b]
        jstate, jm = jstep(jstate, jnp.array(rs))
        tstate, tm = tstep(tstate, _t(rs), _t(us[i]))
        np.testing.assert_allclose(tm.gain_int.numpy(), np.asarray(jm.gain_int),
                                   rtol=RTOL, atol=1e-5 * tcfg.k * c_f)
        np.testing.assert_allclose(tm.gain_frac.numpy(), np.asarray(jm.gain_frac),
                                   rtol=RTOL, atol=1e-5 * tcfg.k * c_f)
        np.testing.assert_array_equal(tm.served_local.numpy(),
                                      np.asarray(jm.served_local))
        np.testing.assert_allclose(tstate.y.numpy(), np.asarray(jstate.y),
                                   rtol=RTOL, atol=1e-5)
        np.testing.assert_array_equal(tstate.x.numpy(), np.asarray(jstate.x))
        np.testing.assert_array_equal(tm.fetched.numpy(), np.asarray(jm.fetched))
        np.testing.assert_array_equal(tm.occupancy.numpy(), np.asarray(jm.occupancy))
    assert tstate.t == int(jstate.t) == steps * b


def test_dedup_mask_matches_reference():
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 40, (6, 30))
    ids[:, ::7] = 50  # invalid sentinel slots (>= n)
    want = np.asarray(jpol.dedup_mask_batched(jnp.array(ids), 50))
    np.testing.assert_array_equal(tpol.dedup_mask_batched(_t(ids), 50).numpy(), want)
    np.testing.assert_array_equal(tpol.dedup_mask(_t(ids[0]), 50).numpy(), want[0])


def test_b1_make_step_is_the_batched_step():
    cat, reqs, _ = jtrace.sift_like(n=300, d=8, t=4, seed=4)
    _, tcfg = _configs(0.5, h=16)
    fn = tpol.exact_candidate_fn_batched(_t(cat), 32, 16)
    s0 = tpol.init_state(300, tcfg, seed=1, device="cpu")
    u = torch.rand(300, generator=torch.Generator().manual_seed(3))
    s1, m1 = tpol.make_step(tcfg, fn)(tpol.copy_state(s0), _t(reqs[0]), u)
    s2, m2 = tpol.make_step_batched(tcfg, fn, 1)(tpol.copy_state(s0), _t(reqs[:1]), u)
    assert float(m1.gain_int) == float(m2.gain_int[0])
    assert torch.equal(s1.y, s2.y) and torch.equal(s1.x, s2.x)


@pytest.mark.parametrize("kind", ["exact", "ivf"])
def test_sift_replay_nag_matches_reference(kind):
    """The BENCH_pipeline.json sift cell (n = 2000, d = 16, 2048 requests,
    h = 64, k = 8, c_remote = 32, c_local = 16, eta = 0.05 / c_f), B = 8."""
    n, t, b = 2000, 2048, 8
    cat, reqs, _ = jtrace.sift_like(n=n, d=16, t=t, seed=0)
    c_f = float(j_calibrate(jnp.array(cat), kth=50, sample=256))
    jcfg = jpol.AcaiConfig(h=64, k=8, c_f=c_f, c_remote=32, c_local=16,
                           oma=joma.OMAConfig(eta=0.05 / c_f))
    tcfg = tpol.AcaiConfig(h=64, k=8, c_f=c_f, c_remote=32, c_local=16,
                           oma=toma.OMAConfig(eta=0.05 / c_f))
    if kind == "exact":
        jfn = jpol.exact_candidate_fn_batched(jnp.array(cat), 32, 16)
        tfn = tpol.exact_candidate_fn_batched(_t(cat), 32, 16)
    else:
        ref = JIVF(jnp.array(cat), nlist=48, nprobe=10)
        jfn = jcand.index_candidate_fn_batched(ref, jnp.array(cat), 32, 16, h=64)
        port = convert.ivf_from_numpy(cat, np.asarray(ref.centroids),
                                      np.asarray(ref.invlists), 10, device="cpu")
        tfn = tcand.index_candidate_fn_batched(port, _t(cat), 32, 16, h=64)
    jstate = jpol.init_state(n, jcfg)
    tstate = convert.cache_state_from_numpy(jstate.y, jstate.x, 0, device="cpu")
    us = reference_uniforms(jstate.key, n, t // b)
    _, jm = jpol.make_replay_batched(jcfg, jfn, b)(jstate, jnp.array(reqs))
    _, tm = tpol.make_replay_batched(tcfg, tfn, b)(tstate, _t(reqs), _t(us))
    nag_ref = float(np.sum(np.asarray(jm.gain_int))) / (8 * c_f * t)
    nag = float(tm.gain_int.sum()) / (8 * c_f * t)
    assert abs(nag - nag_ref) < 1e-3, (nag, nag_ref)
    assert tm.gain_int.shape == (t,)


def test_acai_cache_static_api():
    cat, reqs, _ = jtrace.sift_like(n=400, d=8, t=24, seed=5)
    cfg = tpol.AcaiConfig(h=20, k=4, c_f=0.3, c_remote=16, c_local=8,
                          index=IndexSpec("ivf", {"nlist": 8, "nprobe": 4}))
    cache = tpol.AcaiCache(cat, cfg, device="cpu")
    total = 0.0
    for i in range(0, 16, 8):
        m = cache.serve_update_batch(_t(reqs[i:i + 8]))
        assert m.gain_int.shape == (8,) and torch.isfinite(m.gain_int).all()
        total += float(m.gain_int.sum())
    m1 = cache.serve_update(_t(reqs[16]))
    assert m1.gain_int.dim() == 0
    assert cache.state.t == 17
    assert cache.cached_ids.numel() == int(cache.state.x.sum())
    assert 0.0 <= cache.normalized_gain(total, 16) <= 1.0
    assert cache.index is not None and cache.index.n == 400
    # the catalog mutates online (the parity tests: tests/test_torch_mutable.py)
    assert cache.add_objects(np.zeros((1, 8), np.float32)).tolist() == [400]
    assert cache.live_count == 401
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        tpol.AcaiCache(cat, cfg, device="cpu", mesh=object())
    with pytest.raises(TypeError, match="answer_cache"):
        tpol.AcaiCache(cat, cfg, device="cpu", answer_cache=object())
    # the answer tier fronts a spec-built index (cfg.index): here the
    # candidates are the escape hatch's, so it is refused as in the reference
    with pytest.raises(ValueError, match="cfg.index"):
        tpol.AcaiCache(cat, tpol.AcaiConfig(h=8, k=4), device="cpu", answer_cache=8)
    with pytest.raises(ValueError, match="NaN/Inf"):
        cache.serve_update_batch(torch.full((2, 8), float("nan")))
