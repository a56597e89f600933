"""Port parity of the baselines: `repro_torch.core.baselines` against
`repro.core.baselines` on the same numpy inputs.

- The server oracle: ids equal to the reference's, d2 to rtol 1e-5 (atol
  1e-5 for the self-distances, which are float32 cancellation noise
  around 0), in trace mode, online (`retain_all=False`), after
  `add_objects` / `remove_objects` / `compact` (remaps equal).
- `ref.l2_topk_chunked_ref` (the oracle's plain version) is bitwise
  `ref.l2_topk_ref` at several chunk sizes, ties, tombstones and k > N
  included.
- Each baseline, plain and augmented, fed the reference oracle's answers:
  hit, served_local and fetched equal; gain and cost to 1e-5.
"""

import numpy as np
import pytest
import torch

from repro.core import baselines as JB
from repro.core import trace as jtrace
from repro_torch.core import baselines as TB
from repro_torch.kernels import ref

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def data():
    catalog, reqs, _ = jtrace.sift_like(n=400, d=16, t=96, seed=0)
    return catalog, reqs


def _same_answers(jo, to):
    np.testing.assert_array_equal(to.ids, jo.ids)
    np.testing.assert_allclose(to.d2, jo.d2, **TOL)


@pytest.mark.parametrize("chunk", [None, 64, 97])
def test_oracle_precompute_matches_reference(data, chunk):
    catalog, reqs = data
    jo = JB.ServerOracle(catalog, reqs, kmax=16, chunk=chunk)
    to = TB.ServerOracle(catalog, reqs, kmax=16, chunk=chunk, device="cpu")
    _same_answers(jo, to)
    assert to.t == jo.t == 96 and to.chunk == jo.chunk
    for t in (0, 17, 95):
        for a, b in zip(to.knn(t, 5), jo.knn(t, 5)):
            np.testing.assert_allclose(a, b, **TOL)
        assert to.empty_cost(t, 4, 1.5) == pytest.approx(jo.empty_cost(t, 4, 1.5), rel=1e-5)
    np.testing.assert_array_equal(to.knn_block(np.arange(8, 16), 7),
                                  jo.knn_block(np.arange(8, 16), 7))


def test_oracle_online_extend_matches_reference(data):
    catalog, reqs = data
    jo = JB.ServerOracle(catalog, kmax=16, retain_all=False)
    to = TB.ServerOracle(catalog, kmax=16, retain_all=False, device="cpu")
    for s in (0, 8, 16):
        np.testing.assert_array_equal(to.extend(reqs[s:s + 8]), jo.extend(reqs[s:s + 8]))
        _same_answers(jo, to)
    with pytest.raises(KeyError):  # only the latest block is retained
        to.knn(3, 4)
    # ensure() repairs a stale read with one scan, booked as a recompute
    assert to.ensure(np.arange(4), reqs[:4]) == jo.ensure(np.arange(4), reqs[:4]) == 4
    assert to.remote_recomputes == 4
    np.testing.assert_array_equal(to.knn(2, 6)[0], jo.knn(2, 6)[0])


def test_oracle_mutation_and_compaction_match_reference(data):
    """Tombstones reach the scan as `valid` (the port's device catalog is
    never padded); an id past the live catalog never surfaces."""
    catalog, reqs = data
    jo = JB.ServerOracle(catalog, reqs[:16], kmax=16)
    to = TB.ServerOracle(catalog, reqs[:16], kmax=16, device="cpu")
    new = reqs[40:43] + 1e-3
    np.testing.assert_array_equal(to.add_objects(new), jo.add_objects(new))
    with pytest.raises(KeyError):  # precomputed answers went stale
        to.knn(3, 4)
    # remove one new row, two old ones and the nearest rows of the next
    # requests
    probe = TB.ServerOracle(to.catalog, reqs[16:24], kmax=4, device="cpu").ids[:, 0]
    dead = np.unique(np.concatenate([[401, 5, 77], probe]))
    to.remove_objects(dead)
    jo.remove_objects(dead)
    np.testing.assert_array_equal(to.extend(reqs[16:32]), jo.extend(reqs[16:32]))
    _same_answers(jo, to)
    assert not np.isin(to.ids, dead).any()
    assert to.ids.max() < to.catalog.shape[0] == 403
    with pytest.raises(ValueError, match="already dead"):
        to.remove_objects(dead[:1])
    remap_t, remap_j = to.compact(), jo.compact()
    np.testing.assert_array_equal(remap_t, remap_j)
    np.testing.assert_array_equal(to.catalog, jo.catalog)
    np.testing.assert_array_equal(to.extend(reqs[32:48]), jo.extend(reqs[32:48]))
    _same_answers(jo, to)


@pytest.mark.parametrize("chunk", [2, 7, 64, 97, 256, 5000])
def test_chunked_plain_topk_is_bitwise_the_plain_topk(chunk):
    """Random data at chunks of 64 rows and more (every chunk, the tail
    included, at least 4 rows, 8 queries and more: there the CPU GEMM sums
    each distance in one order whatever the block; at 1-3 rows it switches
    kernels and a distance's last bit may move), and small-integer data,
    whose distances are exact and tie everywhere, at every chunk."""
    g = torch.Generator().manual_seed(chunk)
    for (q, n, d) in [(9, 150, 16), (64, 1000, 32)][:1 if chunk < 64 else 2]:
        qa, xa = torch.randn(q, d, generator=g), torch.randn(n, d, generator=g)
        qi = torch.randint(-2, 3, (q, d), generator=g).float()
        xi = torch.randint(-2, 3, (n, d), generator=g).float()
        valid = torch.rand(n, generator=g) < 0.6
        for (qq, xx) in ((qa, xa), (qi, xi))[(chunk < 64):]:
            for k in (1, 10, 128, n + 5)[:4 if n < 1000 else 3]:
                for v in (None, valid):
                    want = ref.l2_topk_ref(qq, xx, k, v)
                    got = ref.l2_topk_chunked_ref(qq, xx, k, chunk, v)
                    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (
                        q, n, k, chunk, v is None)


# (name, kwargs) of each baseline at the tiny scale, plain and augmented
CASES = [(name, kw, aug) for name, kw in (
    ("LRU", dict(h=24, k=4)),
    ("SIM-LRU", dict(h=24, k=4, k_prime=8, c_theta=1.5)),
    ("CLS-LRU", dict(h=24, k=4, k_prime=8, c_theta=1.5)),
    ("RND-LRU", dict(h=24, k=4, k_prime=8, c_theta=1.5)),
    ("QCACHE", dict(h=24, k=4)),
) for aug in (False, True)]


@pytest.mark.parametrize("name,kw,aug", CASES)
def test_baseline_decisions_match_reference(data, name, kw, aug):
    """Fed the reference oracle's answers, the port's policy takes every
    decision the reference's takes."""
    catalog, reqs = data
    jo = JB.ServerOracle(catalog, reqs, kmax=16)
    to = TB.ServerOracle(catalog, reqs, kmax=16, device="cpu")
    to.ids, to.d2 = jo.ids.copy(), jo.d2.copy()
    common = dict(c_f=1.0, seed=0, augmented=aug, **kw)
    jp = JB.POLICIES[name](catalog, jo, **common)
    tp = TB.POLICIES[name](catalog, to, **common)
    jr, tr = [], []
    for s in range(0, 96, 8):
        ts = np.arange(s, s + 8)
        jr += jp.step_batch(ts, reqs[s:s + 8])
        tr += tp.step_batch(ts, reqs[s:s + 8])
    for field in ("hit", "served_local", "fetched"):
        np.testing.assert_array_equal([getattr(r, field) for r in tr],
                                      [getattr(r, field) for r in jr], err_msg=field)
    for field in ("gain", "cost"):
        np.testing.assert_allclose([getattr(r, field) for r in tr],
                                   [getattr(r, field) for r in jr], err_msg=field, **TOL)
    np.testing.assert_array_equal(tp.cached_object_ids(), jp.cached_object_ids())
    assert any(r.hit for r in tr) or name in ("LRU", "QCACHE")


def test_run_policy_and_nag_match_reference(data):
    catalog, reqs = data
    jo = JB.ServerOracle(catalog, reqs, kmax=16)
    to = TB.ServerOracle(catalog, reqs, kmax=16, device="cpu")
    to.ids, to.d2 = jo.ids.copy(), jo.d2.copy()
    kw = dict(h=24, k=4, c_f=1.0, k_prime=8, c_theta=1.5)
    jm = JB.run_policy(JB.SimLRU(catalog, jo, **kw), reqs)
    tm = TB.run_policy(TB.SimLRU(catalog, to, **kw), reqs)
    np.testing.assert_array_equal(tm["hit"], jm["hit"])
    np.testing.assert_allclose(TB.nag(tm["gain"], 4, 1.0), JB.nag(jm["gain"], 4, 1.0), **TOL)


def test_step_degraded_is_not_ported(data):
    """The resilient tier's local-only serve, once a NotImplementedError,
    is ported: on the same cache contents it gives the reference's answer
    (shed on an empty cache; the cached objects within the ceiling after
    warm-up), and it never touches the LRU state."""
    catalog, reqs = data
    jo = JB.ServerOracle(catalog, reqs, kmax=8)
    to = TB.ServerOracle(catalog, reqs, kmax=8, device="cpu")
    to.ids, to.d2 = jo.ids.copy(), jo.d2.copy()
    kw = dict(h=16, k=4, c_f=1.0)
    pol, jpol = TB.SimLRU(catalog, to, **kw), JB.SimLRU(catalog, jo, **kw)
    (res, shed), (jres, jshed) = pol.step_degraded(reqs[0]), jpol.step_degraded(reqs[0])
    assert shed and jshed and res.gain == jres.gain == 0.0
    for t in range(12):
        pol.step(t, reqs[t])
        jpol.step(t, reqs[t])
    before = list(pol.entries)
    for t in (3, 11, 20):
        (res, shed), (jres, jshed) = pol.step_degraded(reqs[t]), jpol.step_degraded(reqs[t])
        assert shed == jshed and res.served_local == jres.served_local
        np.testing.assert_allclose([res.gain, res.cost], [jres.gain, jres.cost], **TOL)
    assert list(pol.entries) == before
