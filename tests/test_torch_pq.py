"""Port parity, IVF-PQ: repro_torch's `pq_adc` plain versions, `PQCodec`,
`IVFPQIndex` and an `ivfpq` AcaiCache replay against repro's, on the CPU.

The ADC sum runs in m order, one float32 add at a time, as the reference
kernel's fori_loop of one-hot products does, so for the same LUT the
port's ADC distances equal the reference's bitwise.  Everything trained
(k-means centroids, codebooks, LUTs) agrees to rtol 1e-5, atol 1e-5 x the
distance scale (another summation order); codes are equal on the
clustered catalog; query ids equal wherever the reference's margin
exceeds that tolerance.  The reference's initial k-means rows are drawn
from its `jax.random` keys and injected.
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
from repro.index import IndexSpec as JSpec
from repro.index import candidates as jcand
from repro.index.pq import IVFPQIndex as JIVFPQ
from repro.index.pq import PQCodec as JPQ
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import oma as toma
from repro_torch.core import policy as tpol
from repro_torch.index import candidates as tcand
from repro_torch.index.base import IndexSpec
from repro_torch.index.pq import IVFPQIndex, PQCodec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_topk(gd, gi, wd, wi, scale):
    gd, gi, wd, wi = (np.asarray(a) for a in (gd, gi, wd, wi))
    tol = 1e-5 * scale
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=tol)
    np.testing.assert_array_equal(gi == -1, wi == -1)
    finite = np.where(np.isfinite(wd), wd, 1e30)
    gap = np.diff(finite, axis=1)
    inf = np.full((wd.shape[0], 1), np.inf)
    margin = np.minimum(np.concatenate([inf, gap], 1), np.concatenate([gap, inf], 1))
    decided = margin > tol + RTOL * np.abs(finite)
    np.testing.assert_array_equal(gi[decided], wi[decided])


def reference_init_rows(seed: int, n: int, k: int, m: int | None = None):
    """The initial k-means rows the reference draws: `choice(PRNGKey(seed))`
    for the coarse quantizer, `choice` under each of `split(PRNGKey(seed),
    m)` for the m codebooks."""
    def draw(key):
        return np.asarray(jax.random.choice(key, n, shape=(k,), replace=False))

    if m is None:
        return draw(jax.random.PRNGKey(seed))
    return np.stack([draw(key) for key in jax.random.split(jax.random.PRNGKey(seed), m)])


@pytest.fixture(scope="module")
def clustered():
    cat, reqs, _ = jtrace.amazon_like(n=1200, d=16, t=64, clusters=12, seed=3)
    return cat, reqs


@pytest.mark.parametrize("q,n,m,c", [(2, 64, 4, 16), (128, 300, 8, 256),
                                     (5, 1000, 16, 256), (1, 50, 2, 4)])
def test_pq_adc_plain_is_bitwise_the_reference_kernel(q, n, m, c):
    """Dense and gathered forms vs the reference's Pallas kernel in
    interpret mode (tests/test_kernels.py's shapes and data)."""
    rng = np.random.default_rng(2)
    lut = rng.random((q, m, c)).astype(np.float32)
    codes = rng.integers(0, c, (n, m)).astype(np.int32)
    want = np.asarray(jops.pq_adc(jnp.array(lut), jnp.array(codes), interpret=True))
    np.testing.assert_array_equal(tref.pq_adc_ref(_t(lut), _t(codes)).numpy(), want)
    # the wrapper on CPU tensors is the plain version, uint8 codes too
    np.testing.assert_array_equal(
        tops.pq_adc(_t(lut), _t(codes.astype(np.uint8))).numpy(), want)
    cand = rng.integers(0, n, (q, 3 * n + 7)).astype(np.int32)
    cand[rng.random(cand.shape) < 0.3] = -1
    got = tops.pq_adc_gather(_t(lut), _t(codes.astype(np.uint8)), _t(cand)).numpy()
    gathered = want[np.arange(q)[:, None], np.clip(cand, 0, None)]
    np.testing.assert_array_equal(got, np.where(cand >= 0, gathered, np.inf))


@pytest.mark.parametrize("b,p", [(1, 1), (8, 66496), (64, 66496), (3, 1000),
                                 (64, 300)])
def test_pq_adc_launch_covers_every_slot_once(b, p):
    chunk, nchunks = tops.pq_adc_chunks(b, p)
    assert chunk % 256 == 0 and chunk >= 256
    assert (nchunks - 1) * chunk < p <= nchunks * chunk
    assert nchunks <= 65535


@pytest.mark.parametrize("m", [4, 8])
def test_pq_codec_matches_reference(clustered, m):
    cat, reqs = clustered
    ref = JPQ(jnp.array(cat), m=m, seed=1)
    init = reference_init_rows(1, cat.shape[0], 256, m)
    port = PQCodec.train(_t(cat), m, seed=1, init_idx=init)
    np.testing.assert_allclose(port.codebooks.numpy(), np.asarray(ref.codebooks),
                               rtol=RTOL, atol=1e-5 * 10)
    codes = port.encode(_t(cat))
    assert codes.dtype == torch.uint8
    want_codes = np.asarray(ref.encode(jnp.array(cat)))
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    # with the reference's codebooks: decode exactly, LUTs to tolerance
    loaded = PQCodec(_t(ref.codebooks))
    np.testing.assert_array_equal(loaded.decode(_t(want_codes)).numpy(),
                                  np.asarray(ref.decode(jnp.array(want_codes))))
    np.testing.assert_allclose(loaded.adc_lut(_t(reqs[:8])).numpy(),
                               np.asarray(ref.adc_lut(jnp.array(reqs[:8]))),
                               rtol=RTOL, atol=1e-5 * 10)


def test_pq_codec_pads_tiny_training_sets():
    data = np.random.default_rng(0).random((40, 8), np.float32)
    ref = JPQ(jnp.array(data), m=2, seed=3)
    port = PQCodec.train(_t(data), 2, seed=3,
                         init_idx=reference_init_rows(3, 40, 40, 2))
    assert port.codebooks.shape == (2, 256, 4)
    np.testing.assert_allclose(port.codebooks.numpy(), np.asarray(ref.codebooks),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_array_equal(port.encode(_t(data)).numpy(),
                                  np.asarray(ref.encode(jnp.array(data))))


@pytest.mark.parametrize("how", ["trained", "loaded"])
@pytest.mark.parametrize("refine", [4, 0])
def test_ivfpq_query_matches_reference(clustered, refine, how):
    cat, reqs = clustered
    n = cat.shape[0]
    ref = JIVFPQ(jnp.array(cat), nlist=12, nprobe=3, m=4, refine=refine)
    if how == "trained":
        port = IVFPQIndex(cat, nlist=12, nprobe=3, m=4, refine=refine,
                          init_idx=reference_init_rows(0, n, 12),
                          pq_init_idx=reference_init_rows(1, n, 256, 4), device="cpu")
        np.testing.assert_array_equal(port.invlists.numpy(), np.asarray(ref.invlists))
        np.testing.assert_array_equal(port.codes.numpy(), np.asarray(ref.codes))
    else:
        port = convert.ivfpq_from_numpy(cat, ref.centroids, ref.invlists,
                                        ref.codec.codebooks, ref.codes, 3, refine,
                                        device="cpu")
    assert port.exact_distances == ref.exact_distances == (refine > 1)
    for b in (1, 8):
        for k in (10, 64):
            wd, wi = ref.query(jnp.array(reqs[:b]), k)
            gd, gi = port.query(_t(reqs[:b]), k)
            assert gi.dtype == torch.int32 and gd.shape == (b, k)
            _check_topk(gd, gi, wd, wi, scale=10.0)


def test_ivfpq_structures_and_bytes(clustered):
    cat = clustered[0]
    idx = IVFPQIndex(cat, nlist=8, nprobe=4, m=4, refine=0, device="cpu")
    assert idx.codes.dtype == torch.uint8 and idx.codes.shape == (cat.shape[0], 4)
    assert idx.codec.codebooks.shape == (4, 256, 4)
    assert not idx.exact_distances
    assert idx.answer_unstable_add and idx.answer_unstable_remove
    pq = idx.codes.nbytes + idx.codec.codebooks.nbytes
    coarse = idx.centroids.nbytes + idx.invlists.nbytes
    assert idx.compressed_bytes() == pq + coarse
    # resident at query time: the list-major code slab the shortlist scans too
    cap = idx.invlists.shape[1]
    assert idx.codes_lists.shape == (8, cap + cap % 2, 4)
    assert idx.memory_bytes() == (idx.embeddings.nbytes + pq + coarse
                                  + idx.codes_lists.nbytes + idx.valid.nbytes)
    with pytest.raises(ValueError, match="together"):
        IVFPQIndex(cat, codes=np.zeros((cat.shape[0], 4), np.int32), device="cpu")


@pytest.mark.parametrize("refine", [4, 0])
def test_ivfpq_candidate_slabs_match_reference(clustered, refine):
    """The candidate builder around IVF-PQ, with its exact re-rank when the
    index returns ADC distances (refine 0)."""
    cat, reqs = clustered
    n, h = cat.shape[0], 48
    y = np.full(n, h / n, np.float32)
    x = (np.random.default_rng(1).random(n) < y).astype(np.float32)
    ref = JIVFPQ(jnp.array(cat), nlist=12, nprobe=4, m=4, refine=refine)
    port = convert.ivfpq_from_numpy(cat, ref.centroids, ref.invlists,
                                    ref.codec.codebooks, ref.codes, 4, refine,
                                    device="cpu")
    jfn = jcand.index_candidate_fn_batched(ref, jnp.array(cat), 32, 16, h=h)
    tfn = tcand.index_candidate_fn_batched(port, _t(cat), 32, 16, h=h)
    wi, wd, wv = (np.asarray(a) for a in jfn(jnp.array(reqs[:8]), jnp.array(x)))
    gi, gd, gv = (a.numpy() for a in tfn(_t(reqs[:8]), _t(x)))
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=1e-5 * 10)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gi, wi)


def test_ivfpq_acai_cache_replay_matches_reference():
    """AcaiCache with IndexSpec("ivfpq") on both sides: the sift trace of
    BENCH_backends (n = 2000, d = 16, h = 64, k = 8, c_remote = 32,
    c_local = 16) with its ivfpq settings, B = 8, 128 requests (the
    reference runs the Pallas ADC in interpret mode).  The port's spec
    loads the reference's trained structures (at m = 8 over 2000 rows a
    2-d subspace's k-means flips a near-tie assignment under last-ulp
    differences, and its codebooks drift apart) and the port takes the
    reference's rounding uniforms; x must be equal after every step and
    NAG within 1e-3."""
    n, t, b = 2000, 128, 8
    cat, reqs, _ = jtrace.sift_like(n=n, d=16, t=t, seed=0)
    c_f = float(j_calibrate(jnp.array(cat), kth=50, sample=256))
    params = {"nlist": 48, "nprobe": 10, "m": 8, "refine": 4}
    jcfg = jpol.AcaiConfig(h=64, k=8, c_f=c_f, c_remote=32, c_local=16,
                           oma=joma.OMAConfig(eta=0.05 / c_f),
                           index=JSpec("ivfpq", params))
    jcache = jpol.AcaiCache(jnp.array(cat), jcfg)
    ref = jcache.index
    loaded = {"centroids": np.asarray(ref.centroids), "invlists": np.asarray(ref.invlists),
              "codebooks": np.asarray(ref.codec.codebooks), "codes": np.asarray(ref.codes)}
    tcfg = tpol.AcaiConfig(h=64, k=8, c_f=c_f, c_remote=32, c_local=16,
                           oma=toma.OMAConfig(eta=0.05 / c_f),
                           index=IndexSpec("ivfpq", {**params, **loaded}))
    state = convert.cache_state_from_numpy(jcache.state.y, jcache.state.x, 0,
                                           device="cpu")
    tcache = tpol.AcaiCache(cat, tcfg, device="cpu", state=state)
    key, us = jcache.state.key, []
    for _ in range(t // b):
        key, k_round = jax.random.split(key)
        us.append(np.asarray(jax.random.uniform(k_round, (n,), dtype=jnp.float32)))
    g_ref = g_port = 0.0
    for i in range(t // b):
        rs = reqs[i * b:(i + 1) * b]
        jm = jcache.serve_update_batch(jnp.array(rs))
        tm = tcache.serve_update_batch(_t(rs), _t(us[i]))
        np.testing.assert_array_equal(tcache.state.x.numpy(), np.asarray(jcache.state.x))
        np.testing.assert_allclose(tm.gain_int.numpy(), np.asarray(jm.gain_int),
                                   rtol=RTOL, atol=1e-5 * 8 * c_f)
        g_ref += float(np.sum(np.asarray(jm.gain_int)))
        g_port += float(tm.gain_int.sum())
    nag_ref, nag = jcache.normalized_gain(g_ref, t), tcache.normalized_gain(g_port, t)
    assert abs(nag - nag_ref) < 1e-3, (nag, nag_ref)
