"""Port parity, the IVF-PQ shortlist's list-major scan
(`ops.pq_shortlist_lists`, the `pq_adc_lists` kernel's wrapper), on the CPU.

The CUDA kernel runs only on the card (chip_smoke.py holds it bitwise
against its plain version there).  Here:
  - the plain version, `ref.pq_shortlist_ref`, equals the JAX reference's
    shortlist (`src/repro/index/pq.py`: the probed table, the Pallas ADC in
    interpret mode, `lax.top_k(-d_adc, r)` and the -1 rule) on the same
    numpy inputs: ids and distances exactly, since the ADC sums run in the
    same order; with the port's own LUT (another framework's float32
    sums), distances to rtol 1e-5, atol 1e-5 x the distance scale, and ids
    wherever the margin exceeds that;
  - a numpy emulation of the kernel's plan (groups of the probe table's
    entries naming a list, runs of `pq_lists_plan`, order-preserving keys,
    the bound read at a group's start and published from full partials,
    the select by histograms of power-of-two bins over the open key range
    with its early stop, slot-ordered partials and the stable merge) returns
    the plain version's ids and distances exactly, on duplicate code rows
    whose ties straddle the kk-th slot, kk > 128, empty lists, probe
    entries outside [0, nlist), fewer live slots than kk and tombstones;
  - the list-major code slab holds codes[invlists[l, s]] at every listed
    slot, for a port-built index and for one loaded from the reference;
  - the plan keeps a query's partials at or under the merge's 4096 and
    covers every slot once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import trace as jtrace
from repro.index.pq import IVFPQIndex as JIVFPQ
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.index.ivf import build_invlists
from repro_torch.index.pq import IVFPQIndex
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

KEY_INF = 0xff800000  # pq_adc_lists.cu: the key of +inf


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def clustered():
    cat, reqs, _ = jtrace.amazon_like(n=1200, d=16, t=64, clusters=12, seed=3)
    return cat, reqs


def _jax_shortlist(ref, q, k, refine):
    """The reference's IVF-PQ shortlist (src/repro/index/pq.py:112-136),
    step by step: probe, probed table, LUT, per-query Pallas ADC in
    interpret mode, top-r and the -1 rule.  Returns numpy (probe, lut,
    dists, ids)."""
    b = q.shape[0]
    dc = jops.pairwise_l2_xla(q, ref.centroids)
    _, probe = jax.lax.top_k(-dc, ref.nprobe)
    cand = ref.invlists[probe].reshape(b, -1)
    lut = ref.codec.adc_lut(q)
    gathered = ref.codes[jnp.clip(cand, 0, None)]
    d_adc = jax.vmap(lambda lt, c: jops.pq_adc(lt[None], c, interpret=True)[0])(lut, gathered)
    d_adc = jnp.where(cand >= 0, d_adc, jnp.inf)
    r = min(refine * k, d_adc.shape[1])
    neg, pos = jax.lax.top_k(-d_adc, r)
    rid = jnp.take_along_axis(cand, pos, axis=1)
    rid = jnp.where(jnp.isfinite(neg), rid, -1)
    return (np.asarray(probe), np.asarray(lut), -np.asarray(neg), np.asarray(rid))


@pytest.mark.parametrize("nlist,nprobe", [(12, 3), (24, 6)])
@pytest.mark.parametrize("b,k", [(1, 10), (8, 10), (8, 64)])
def test_plain_shortlist_is_the_reference_shortlist(clustered, nlist, nprobe, b, k):
    cat, reqs = clustered
    ref = JIVFPQ(jnp.array(cat), nlist=nlist, nprobe=nprobe, m=4, refine=4)
    port = convert.ivfpq_from_numpy(cat, ref.centroids, ref.invlists, ref.codec.codebooks,
                                    ref.codes, nprobe, 4, device="cpu")
    probe, lut, wd, wi = _jax_shortlist(ref, jnp.array(reqs[:b]), k, 4)
    kk = wi.shape[1]
    # the same numpy inputs: bit for bit
    gd, gi = tref.pq_shortlist_ref(_t(lut), port.codes_lists, port.invlists,
                                   _t(probe.astype(np.int32)), kk)
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_array_equal(gd.numpy(), wd)
    # the wrapper on CPU tensors is the plain version
    td, ti = tops.pq_shortlist_lists(_t(lut), port.codes_lists, port.invlists,
                                     _t(probe.astype(np.int32)), kk, lens=port.lens)
    assert torch.equal(td, gd) and torch.equal(ti, gi)
    # the port's own probe and LUT: another framework's float32 sums of the
    # LUT's expansion, held as tests/test_torch_pq.py holds the index
    # (rtol 1e-5, atol 1e-5 x the distance scale; ids where decided)
    pd, pi = port.shortlist(_t(reqs[:b]), k)
    assert pi.dtype == torch.int32 and pd.shape == (b, kk)
    pd, pi = pd.numpy(), pi.numpy()
    tol = 1e-5 * 10.0
    np.testing.assert_allclose(pd, wd, rtol=1e-5, atol=tol)
    np.testing.assert_array_equal(pi == -1, wi == -1)
    fin = np.where(np.isfinite(wd), wd, 1e30)
    gap = np.diff(fin, axis=1)
    inf = np.full((b, 1), np.inf)
    margin = np.minimum(np.concatenate([inf, gap], 1), np.concatenate([gap, inf], 1))
    decided = margin > tol + 1e-5 * np.abs(fin)
    np.testing.assert_array_equal(pi[decided], wi[decided])


def test_plain_shortlist_folds_tombstones_as_the_reference(clustered):
    """The masked branch: tombstoned ids become -1 slots before the ADC."""
    cat, reqs = clustered
    ref = JIVFPQ(jnp.array(cat), nlist=12, nprobe=3, m=4, refine=4)
    port = convert.ivfpq_from_numpy(cat, ref.centroids, ref.invlists, ref.codec.codebooks,
                                    ref.codes, 3, 4, device="cpu")
    valid = np.random.default_rng(4).random(cat.shape[0]) < 0.6
    probe, lut, _, _ = _jax_shortlist(ref, jnp.array(reqs[:8]), 64, 4)
    inv = np.asarray(ref.invlists)
    cand = inv[probe].reshape(8, -1)
    cand = np.where((cand >= 0) & valid[np.clip(cand, 0, None)], cand, -1)
    d = np.asarray(jax.vmap(lambda lt, c: jops.pq_adc(lt[None], c, interpret=True)[0])(
        jnp.array(lut), jnp.asarray(ref.codes)[np.clip(cand, 0, None)]))
    d = np.where(cand >= 0, d, np.inf)
    neg, pos = jax.lax.top_k(-jnp.array(d), 256)
    wi = np.where(np.isfinite(np.asarray(neg)), np.take_along_axis(cand, np.asarray(pos), 1), -1)
    gd, gi = tref.pq_shortlist_ref(_t(lut), port.codes_lists, port.invlists,
                                   _t(probe.astype(np.int32)), 256, _t(valid))
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_array_equal(gd.numpy(), -np.asarray(neg))
    assert valid[gi.numpy()[gi.numpy() >= 0]].all()


# ---------------------------------------------------------------------------
# the kernel's plan, emulated in numpy


def _f2key(d):
    """pq_adc_lists.cu's order-preserving key of float32 distances (-0 as
    +0), as int64."""
    b = np.where(d == 0, 0, d.astype(np.float32).view(np.uint32)).astype(np.int64)
    return np.where(b & 0x80000000, ~b & 0xffffffff, b | 0x80000000)


def _key2f(k):
    b = np.where(k & 0x80000000, k & 0x7fffffff, ~k & 0xffffffff).astype(np.uint32)
    return b.view(np.float32)


def _select(keys, cand, kp):
    """The kernel's selection over one (query, run): (kept slots as a mask,
    how it ended).  Every candidate when there are at most kp ("all");
    else histograms over the open key range [lo, hi] (at first the
    candidates' smallest to largest key) in at most 256 bins of 2^sh keys,
    each pass narrowing it to the bin of the kp-th key, stopping when that
    bin is taken whole ("bucket") or holds one key, the first ones in slot
    order taken ("ties")."""
    how, need = "all", kp
    if cand.sum() <= kp:
        lo, hi = 0, 0xffffffff
    else:
        lo, hi = int(keys[cand].min()), int(keys[cand].max())
        how = "ties"
        for _ in range(4):
            if lo == hi:
                break
            sh = max(0, (hi - lo).bit_length() - 8)   # ceil(log2 width) - 8
            inr = cand & (keys >= lo) & (keys <= hi)
            h = np.bincount((keys[inr] - lo) >> sh, minlength=256)
            assert len(h) == 256
            cum = np.cumsum(h)
            t = int(np.searchsorted(cum, need))  # the bin of the need-th
            left = need - int(cum[t] - h[t])
            lo, hi = lo + (t << sh), min(hi, lo + ((t + 1) << sh) - 1)
            need = left
            if h[t] == left:
                how = "bucket" if lo != hi else "ties"
                break
        assert lo == hi or how == "bucket"
    lt, eq = cand & (keys < lo), cand & (keys >= lo) & (keys <= hi)
    return lt | (eq & (np.cumsum(eq) <= need)), how


def _emulate(lut, codes_lists, invlists, probe, kk, valid=None, order=1, hows=None):
    """pq_adc_lists' plan in numpy: blocks (list, run, z) in grid order
    (order = -1: the reverse, another schedule of the same grid), each
    taking the probe table's entries naming its list in table order, gmax
    at a time, every qsplit-th group from the z-th; returns the wrapper's
    merge of the partials.  `hows`, a set, collects how the selections
    ended."""
    lut, codes_lists = lut.numpy(), codes_lists.numpy()
    inv, probe = invlists.numpy(), probe.numpy()
    b, m, c = lut.shape
    nlist, cap = inv.shape
    nprobe = probe.shape[1]
    n = valid.shape[0] if valid is not None else 2 ** 31 - 1
    lens = tops.invlist_lengths(invlists).numpy()
    nruns, run, gmax, qsplit = tops.pq_lists_plan(nlist, cap, nprobe, kk, m, c, b)
    kp = min(kk, run)
    pd = np.full((b, nprobe * nruns * kp), np.nan, np.float32)
    pi = np.full(pd.shape, -99, np.int32)
    bound = np.full(b, 0xffffffff, np.int64)
    flat = probe.reshape(-1)
    for e in np.nonzero((flat < 0) | (flat >= nlist))[0]:
        pd[e // nprobe, (e % nprobe) * nruns * kp:(e % nprobe + 1) * nruns * kp] = np.inf
        pi[e // nprobe, (e % nprobe) * nruns * kp:(e % nprobe + 1) * nruns * kp] = -1
    for blk in range(nlist * nruns * qsplit)[::order]:
        lst, j, z = blk // (nruns * qsplit), blk // qsplit % nruns, blk % qsplit
        hits = np.nonzero(flat == lst)[0]               # table order
        s0 = j * run
        s1 = max(s0, min(s0 + run, int(lens[lst])))
        ids = inv[lst, s0:s1]
        live = (ids >= 0) & (ids < n)
        if valid is not None:
            live &= valid.numpy()[np.clip(ids, 0, n - 1)]
        rows = torch.from_numpy(codes_lists[lst, s0:s1].astype(np.int64))
        for g0 in range(z * gmax, len(hits), qsplit * gmax):
            group = hits[g0:g0 + gmax]
            bks = bound[group // nprobe].copy()   # read at the group's start
            for e, bk in zip(group, bks):
                bq, r = divmod(int(e), nprobe)
                dist = tref._adc_sum(torch.from_numpy(lut[bq:bq + 1]),
                                     lambda mi: rows[:, mi][None, :])[0].numpy()
                keys = np.where(live, _f2key(dist), 0xffffffff)
                cand = (keys < KEY_INF) & (keys <= bk)
                keep, how = _select(keys, cand, kp)
                if hows is not None:
                    hows.add(how)
                kept = np.nonzero(keep)[0]                  # slot order
                at = (r * nruns + j) * kp
                pd[bq, at:at + kp] = np.inf
                pi[bq, at:at + kp] = -1
                pd[bq, at:at + len(kept)] = _key2f(keys[kept])
                pi[bq, at:at + len(kept)] = ids[kept]
                if len(kept) == kp:
                    bound[bq] = min(bound[bq], int(keys[kept].max()))
    assert not np.isnan(pd).any(), "a partial slot was never written"
    vals, out = tops._merge_partials(torch.from_numpy(pd), torch.from_numpy(pi),
                                     min(kk, pd.shape[1]))
    short = kk - vals.shape[1]
    if short > 0:
        vals = torch.cat([vals, vals.new_full((b, short), float("inf"))], 1)
        out = torch.cat([out, out.new_full((b, short), -1)], 1)
    return vals, out


def _pq_case(seed, n, nlist, b, nprobe, m=8, c=256, *, distinct=0, int_lut=False,
             empty=(), tombstone=0, outside=False, equal=False):
    """A LUT, a code slab and its lists: `distinct` > 0 draws every code row
    from that many distinct rows (ADC ties across the kk-th slot), an
    integer LUT makes every sum exact (more ties), `empty` lists hold
    nothing, every `tombstone`-th listed id becomes -1 mid-list, `outside`
    puts probe entries past either end of [0, nlist), `equal` gives every
    query the first one's LUT and probe (groups beyond gmax)."""
    rng = np.random.default_rng(seed)
    if int_lut:
        lut = rng.integers(0, 6, (b, m, c)).astype(np.float32)
    else:
        lut = (rng.random((b, m, c)) * 10).astype(np.float32)
    if distinct:
        pool = rng.integers(0, c, (distinct, m))
        codes = pool[rng.integers(0, distinct, n)]
    else:
        codes = rng.integers(0, c, (n, m))
    assign = rng.integers(0, nlist, n)
    for e in empty:
        assign[assign == e] = (e + 1) % nlist
    inv = build_invlists(assign, nlist)
    if tombstone:
        inv[(inv >= 0) & (inv % tombstone == 1)] = -1
    probe = np.stack([rng.permutation(nlist)[:nprobe] for _ in range(b)]).astype(np.int32)
    if empty:
        probe[0, 0] = empty[0]
    if outside:
        probe[1, 0], probe[2, -1] = nlist, -1
    if equal:
        lut[:] = lut[0]
        probe[:] = probe[0]
    codes_t = torch.from_numpy(codes.astype(np.uint8))
    inv_t = torch.from_numpy(inv)
    return (torch.from_numpy(lut), tops.codes_by_list(codes_t, inv_t), inv_t,
            torch.from_numpy(probe))


# (seed, n, nlist, B, nprobe, kk, case options, how the selections end):
# the slice's shape cut small (kk 256 = refine 4 x k 64, runs longer than
# kk), kk above 128, duplicate code rows and integer LUTs (ties across the
# kk-th slot), empty lists, entries naming no list, kk beyond the live
# slots, tombstones, groups beyond gmax, M 4 and C 16
PLAN_CASES = [
    (0, 6000, 6, 9, 3, 256, {}, {"all", "bucket"}),
    (1, 6000, 6, 8, 3, 256, {"distinct": 12}, {"all", "ties"}),
    (2, 3000, 5, 7, 3, 200, {"int_lut": True, "empty": (3,)}, {"all", "bucket", "ties"}),
    (3, 2500, 5, 6, 4, 130, {"distinct": 5, "int_lut": True, "outside": True},
     {"all", "ties"}),
    (4, 600, 40, 5, 3, 64, {"tombstone": 4, "empty": (0,)}, {"all"}),  # kk > the live slots
    (5, 2000, 4, 13, 2, 30, {"equal": True, "distinct": 40}, {"all", "ties"}),
    (6, 1500, 3, 4, 2, 17, {"m": 4, "c": 16, "int_lut": True}, {"all", "ties"}),
    (7, 900, 2, 3, 2, 1, {"distinct": 3}, {"all", "ties"}),
]


@pytest.mark.parametrize("seed,n,nlist,b,nprobe,kk,opts,want", PLAN_CASES)
def test_list_major_plan_is_the_plain_shortlist(seed, n, nlist, b, nprobe, kk, opts, want):
    lut, cl, inv, probe = _pq_case(seed, n, nlist, b, nprobe, **opts)
    valid = torch.from_numpy(np.random.default_rng(seed).random(n) < 0.7)
    hows = set()
    for v in (None, valid):
        wd, wi = tref.pq_shortlist_ref(lut, cl, inv, probe, kk, v)
        for order in (1, -1):
            gd, gi = _emulate(lut, cl, inv, probe, kk, v, order, hows)
            assert torch.equal(gi, wi) and torch.equal(gd, wd)
    assert want <= hows, hows   # the case reaches the selection's paths it is for


def test_duplicate_codes_tie_across_the_kth_slot():
    """The case the plan must get right: more rows share the kk-th distance
    than fit, inside one run and across runs and probes; the lowest
    positions win."""
    lut, cl, inv, probe = _pq_case(11, 3000, 6, 4, 3, distinct=4, int_lut=True)
    kk = 100
    wd, wi = tref.pq_shortlist_ref(lut, cl, inv, probe, kk)
    # every probed slot's ADC distance: the (B, P) row the plain version cuts
    rows = cl[:, :inv.shape[1]][probe.long()].reshape(4, -1, cl.shape[2]).long()
    d = tref._adc_sum(lut, lambda mi: rows[:, :, mi])
    d = torch.where(tops.probed_table(inv, probe) >= 0, d, float("inf"))
    ties = (d == wd[:, -1:]).sum(1)
    taken = (wd == wd[:, -1:]).sum(1)
    assert bool((ties > taken).all())   # the kk-th distance straddles the cut
    hows = set()
    gd, gi = _emulate(lut, cl, inv, probe, kk, hows=hows)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)
    assert "ties" in hows


@pytest.mark.parametrize("d", [[0.0, -0.0, 1.5, -2.25, 3e38, np.inf, 1e-40],
                               [7.0, 7.0, 6.999999523162842, 7.000000476837158]])
def test_keys_keep_the_float_order(d):
    d = np.array(d, np.float32)
    keys = _f2key(d)
    order = np.argsort(keys, kind="stable")
    assert (np.diff(d[order]) >= 0).all()
    np.testing.assert_array_equal(_key2f(keys)[d != 0], d[d != 0])
    assert len(set(keys[d == 0].tolist())) <= 1    # -0 keys as +0
    assert (keys[np.isinf(d)] == KEY_INF).all()


# ---------------------------------------------------------------------------
# the slab and the plan


@pytest.mark.parametrize("how", ["trained", "loaded"])
def test_codes_lists_hold_each_listed_slots_code_row(clustered, how):
    cat, _ = clustered
    if how == "trained":
        idx = IVFPQIndex(cat, nlist=12, nprobe=3, m=4, refine=4, device="cpu")
    else:
        ref = JIVFPQ(jnp.array(cat), nlist=12, nprobe=3, m=4, refine=4)
        idx = convert.ivfpq_from_numpy(cat, ref.centroids, ref.invlists, ref.codec.codebooks,
                                       ref.codes, 3, 4, device="cpu")
    inv, cl, codes = idx.invlists, idx.codes_lists, idx.codes
    assert cl.dtype == torch.uint8 and cl.shape[0] == inv.shape[0]
    assert cl.shape[1] % 2 == 0 and cl.shape[1] - inv.shape[1] in (0, 1)
    for lst, ln in enumerate(idx.lens.tolist()):
        ids = inv[lst, :ln]
        assert (ids >= 0).all()
        assert torch.equal(cl[lst, :ln], codes[ids.long()])
        assert not cl[lst, ln:].any()


# (nlist, cap, nprobe, kk, m, c): the slice (1M rows in 256 lists, 16
# probed, refine 4 x k 64 and k 10), the parity replay's (2000 rows in 48,
# 10 probed, refine 4 x k 32), few long lists, a long list whose keys need
# more runs, and M 16
@pytest.mark.parametrize("nlist,cap,nprobe,kk,m,c", [
    (256, 4153, 16, 256, 8, 256), (256, 4155, 16, 40, 8, 256), (48, 80, 10, 128, 8, 256),
    (8, 5000, 2, 64, 8, 256), (4, 200000, 2, 256, 8, 256), (64, 3000, 8, 100, 16, 256),
    (300, 1, 5, 5, 4, 16)])
def test_pq_lists_plan_keeps_the_merge_in_one_block(nlist, cap, nprobe, kk, m, c):
    nruns, run, gmax, qsplit = tops.pq_lists_plan(nlist, cap, nprobe, kk, m, c, 64)
    assert run % 2 == 0 and nruns * run >= cap and (nruns - 1) * run < cap
    assert gmax in (1, 2, 4, 8)
    assert tops.pq_lists_smem_bytes_host(gmax, m, c, run, min(kk, run)) <= tops.SMEM_LIMIT
    kp = min(kk, run)
    # within the merge's one-block width wherever one run a list is
    if nprobe * min(kk, cap + cap % 2) <= tops._MERGE_MAX_WIDTH and nruns > 1:
        assert nprobe * nruns * kp <= tops._MERGE_MAX_WIDTH
    if (nlist, cap) == (256, 4153):
        # the slice: one run a list, 16 x 256 = 4096 partials a query, two
        # blocks an SM
        assert (nruns, gmax) == (1, 4) and nprobe * nruns * kp == 4096
    # the groups of a batch's lists spread over blocks, up to 8 a (list, run)
    assert 1 <= qsplit <= 8
    assert tops.pq_lists_plan(nlist, cap, nprobe, kk, m, c, 1)[3] == 1  # one query, one group


def test_pq_lists_plan_covers_every_slot_once():
    """Runs tile [0, cap) without overlap, for every cut the plan makes."""
    for nlist, cap, nprobe, kk in [(256, 4153, 16, 256), (8, 5000, 2, 64), (4, 200000, 2, 256),
                                   (48, 80, 10, 32), (3, 7, 1, 1)]:
        nruns, run = tops.pq_lists_plan(nlist, cap, nprobe, kk, 8, 256)[:2]
        cover = np.zeros(cap, int)
        for j in range(nruns):
            cover[j * run:min((j + 1) * run, cap)] += 1
        assert (cover == 1).all()
