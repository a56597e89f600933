"""Port parity, the IVF probe's list-major scan (`ops.ivf_scan_lists`) and the
generic ivf_scan's launch plan, on the CPU.

The CUDA kernel runs only on the card (chip_smoke.py holds it against its
plain version there, equal on small-integer ties).  Here:
  - the wrapper's plain path is `ivf_scan_topk` over the probed lists'
    table, and an IVF index loaded from the JAX reference answers as
    `repro.index.ivf.IVFFlatIndex` does;
  - a pure-torch emulation of the kernel's plan (the probe inversion in
    table order, groups of GMAX queries, runs of `ivf_lists_plan`, each
    query's warp offering its run's rows in slot order to a sorted top k,
    the (query, probe, run, rank) partial layout and the wrapper's stable
    merge) returns the plain version's ids in the plain version's tie
    order, at ragged shapes and on small-integer ties.
Tolerances: distances rtol 1e-5, atol 1e-5 x the distance scale; ids equal
wherever the reference's margin exceeds that (the emulation reuses the
plain version's distances, so there every id and tie must be equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import trace as jtrace
from repro.index.ivf import IVFFlatIndex as JIVF
from repro_torch import convert
from repro_torch.index.ivf import build_invlists
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RTOL = 1e-5
GMAX, TILE = 8, 32  # ivf_scan_lists.cu: queries a block holds, rows a tile


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


def _lists_case(seed, n, d, nlist, b, nprobe, *, ints=False, empty=(), tombstone=0,
                equal=False, dup=False, outside=False):
    """Catalog, queries, padded lists and a probe table: `empty` lists hold
    nothing, every `tombstone`-th listed id becomes a -1 mid-list, `equal`
    makes every query (and its probe) the first one's, `dup` probes one
    list twice in the first query, `outside` puts entries past either end
    of [0, nlist) in the second and third queries."""
    rng = np.random.default_rng(seed)
    if ints:
        x = rng.integers(-3, 4, (n, d)).astype(np.float32)
        q = rng.integers(-3, 4, (b, d)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        q = rng.normal(size=(b, d)).astype(np.float32)
    assign = rng.integers(0, nlist, n)
    for e in empty:
        assign[assign == e] = (e + 1) % nlist
    inv = build_invlists(assign, nlist)
    if tombstone:
        inv[(inv >= 0) & (inv % tombstone == 1)] = -1
    probe = np.stack([rng.permutation(nlist)[:nprobe] for _ in range(b)]).astype(np.int32)
    if empty:
        probe[0, 0] = empty[0]
    if equal:
        q[:] = q[0]
        probe[:] = probe[0]
    if dup:
        probe[0, -1] = probe[0, 0]
    if outside:
        probe[1, 0], probe[2, -1], probe[2, 0] = nlist, -1, nlist + 7
    return _t(q), _t(x), _t(inv), _t(probe)


# (seed, n, d, nlist, B, nprobe, k, case options): the slice's shape cut
# small, ragged B, k, D and nprobe, empty lists, k beyond a list and beyond
# P, every query probing the same lists, a list probed twice, tombstones
CASES = [
    (0, 3000, 32, 16, 64, 4, 64, {}),
    (1, 3000, 32, 16, 8, 4, 64, {}),
    (2, 1500, 24, 12, 7, 3, 13, {"empty": (3, 5)}),
    (3, 800, 33, 40, 5, 40, 128, {"tombstone": 7}),
    (4, 600, 16, 100, 9, 5, 100, {"empty": (0,)}),      # k > a list and > P
    (5, 2000, 16, 10, 13, 3, 10, {"equal": True}),     # every query on the same lists
    (6, 1000, 8, 9, 3, 4, 17, {"dup": True, "tombstone": 5}),
    (7, 1200, 20, 10, 6, 3, 30, {"outside": True}),    # entries naming no list
]
TIE_CASES = [(k, b) for k in (1, 10, 64, 128) for b in (11, 64)]


@pytest.mark.parametrize("seed,n,d,nlist,b,nprobe,k,opts", CASES)
def test_ivf_scan_lists_plain_is_ivf_scan_topk_over_the_probe_table(seed, n, d, nlist, b,
                                                                    nprobe, k, opts):
    q, x, inv, probe = _lists_case(seed, n, d, nlist, b, nprobe, **opts)
    valid = torch.from_numpy(np.random.default_rng(seed).random(n) < 0.8)
    table = tops.probed_table(inv, probe)
    for v in (None, valid):
        gd, gi = tops.ivf_scan_lists(q, x, inv, probe, k, valid=v)
        wd, wi = tops.ivf_scan_topk(q, x, table, k, valid=v)
        assert torch.equal(gd, wd) and torch.equal(gi, wi)
        rd, ri = tref.ivf_scan_ref(q, x, table, k, v)
        assert torch.equal(gi, ri)


def _emulate_lists(q, x, inv, probe, k, valid=None):
    """The list-major kernel's plan in plain torch, over the plain
    version's distances (the kernel sums each distance in column order; the
    chip check holds it to the plain version within tolerance)."""
    b, d = q.shape
    nlist, cap = inv.shape
    nprobe = probe.shape[1]
    lens = tops.invlist_lengths(inv)
    nruns, run = tops.ivf_lists_plan(nlist, cap, nprobe, k)
    # each probed slot's distance, +inf on -1 slots, past-N ids and dead rows
    ids = inv.long()
    ok = (ids >= 0) & (ids < x.shape[0])
    if valid is not None:
        ok &= valid[ids.clamp(0, x.shape[0] - 1)]
    pd = torch.full((b, nprobe * nruns * k), float("nan"))
    pi = torch.full(pd.shape, -99, dtype=torch.int32)
    inf = float("inf")
    flat = probe.flatten()
    # entries naming no list: their partials are written empty
    for e in ((flat < 0) | (flat >= nlist)).nonzero().flatten().tolist():
        bq, r = divmod(e, nprobe)
        pd[bq, r * nruns * k:(r + 1) * nruns * k] = inf
        pi[bq, r * nruns * k:(r + 1) * nruns * k] = -1
    for lst in range(nlist):
        hits = (flat == lst).nonzero().flatten().tolist()   # table order
        for j in range(nruns):
            s0 = j * run
            s1 = max(s0, min(s0 + run, int(lens[lst])))
            slots = torch.arange(s0, s1)
            live = ok[lst, s0:s1]
            rows_ = x[ids[lst, s0:s1].clamp_min(0)]
            for g0 in range(0, len(hits), GMAX):
                # a group of up to GMAX queries, warp g serving the g-th
                for e in hits[g0:g0 + GMAX]:
                    bq, r = divmod(e, nprobe)
                    dist = torch.full((s1 - s0,), inf)
                    dist[live] = torch.sum((rows_ - q[bq]) ** 2, dim=-1)[live]
                    # the warp offers its rows in slot order, 32 a tile,
                    # each below the list's k-th: a stable top k
                    lv = [inf] * k
                    ls = [-1] * k
                    for t0 in range(0, s1 - s0, TILE):
                        for i in range(t0, min(t0 + TILE, s1 - s0)):
                            v = float(dist[i])
                            if v < lv[-1]:
                                pos = sum(1 for u in lv if u <= v)
                                lv = lv[:pos] + [v] + lv[pos:-1]
                                ls = ls[:pos] + [int(slots[i])] + ls[pos:-1]
                    at = (r * nruns + j) * k  # in query bq's row
                    pd[bq, at:at + k] = torch.tensor(lv)
                    pi[bq, at:at + k] = torch.tensor(
                        [int(inv[lst, s]) if v < inf else -1 for v, s in zip(lv, ls)],
                        dtype=torch.int32)
    assert not torch.isnan(pd).any(), "a partial slot was never written"
    vals, idx = tops._merge_partials(pd, pi, k)
    return vals, torch.where(torch.isfinite(vals), idx, torch.full_like(idx, -1))


@pytest.mark.parametrize("seed,n,d,nlist,b,nprobe,k,opts", CASES)
def test_list_major_plan_keeps_the_plain_ids_and_tie_order(seed, n, d, nlist, b, nprobe,
                                                           k, opts):
    q, x, inv, probe = _lists_case(seed, n, d, nlist, b, nprobe, **opts)
    valid = torch.from_numpy(np.random.default_rng(seed + 1).random(n) < 0.9)
    table = tops.probed_table(inv, probe)
    for v in (None, valid):
        gd, gi = _emulate_lists(q, x, inv, probe, k, v)
        wd, wi = tref.ivf_scan_ref(q, x, table, k, v)
        assert torch.equal(gd, wd) and torch.equal(gi, wi)


@pytest.mark.parametrize("k,b", TIE_CASES)
def test_list_major_plan_breaks_small_integer_ties_as_the_plain_version(k, b):
    """Small-integer rows make every distance exact, so ties abound; the
    lowest position along the (B, nprobe * cap) table must win each one."""
    q, x, inv, probe = _lists_case(11, 3000, 16, 20, b, 7, ints=True, tombstone=9)
    table = inv[probe.long()].reshape(b, -1)
    gd, gi = _emulate_lists(q, x, inv, probe, k)
    wd, wi = tref.ivf_scan_ref(q, x, table, k)
    assert torch.equal(gd, wd) and torch.equal(gi, wi)


def test_invlist_lengths_end_past_the_last_id():
    inv = torch.tensor([[4, 7, -1, 9, -1, -1], [-1] * 6, [1, 2, 3, 5, 6, 8],
                        [-1, -1, 0, -1, -1, -1]], dtype=torch.int32)
    assert tops.invlist_lengths(inv).tolist() == [4, 0, 6, 3]
    assert tops.invlist_lengths(inv).dtype == torch.int32
    assert tops.invlist_lengths(torch.zeros((3, 0), dtype=torch.int32)).tolist() == [0, 0, 0]
    assign = np.random.default_rng(0).integers(0, 7, 500)
    full = build_invlists(assign, 7)
    assert tops.invlist_lengths(_t(full)).tolist() == np.bincount(assign, minlength=7).tolist()


@pytest.mark.parametrize("nlist,nprobe", [(12, 3), (24, 6)])
def test_ivf_loaded_from_reference_scans_list_major_like_it(nlist, nprobe):
    """The loaded index keeps each list's length and its probe table is the
    reference's lists in probe order; its answers are the reference's."""
    cat, reqs, _ = jtrace.amazon_like(n=1200, d=16, t=64, clusters=12, seed=3)
    ref = JIVF(jnp.array(cat), nlist=nlist, nprobe=nprobe, train_iters=4)
    port = convert.ivf_from_numpy(cat, np.asarray(ref.centroids), np.asarray(ref.invlists),
                                  nprobe, device="cpu")
    inv = np.asarray(ref.invlists)
    assert port.lens.tolist() == [int(((row >= 0) * np.arange(1, row.size + 1)).max())
                                  for row in inv]
    q = _t(reqs[:8])
    table = port.probe_table(q)
    assert table.shape == (8, nprobe * inv.shape[1])
    assert torch.equal(table, port.invlists[port.probe_lists(q).long()].reshape(8, -1))
    for k in (1, 10, 64):
        wd, wi = ref.query(jnp.array(reqs[:8]), k)
        gd, gi = port.query(q, k)
        _check_topk(gd, gi, wd, wi, scale=10.0)
        ed, ei = _emulate_lists(q, port.embeddings, port.invlists, port.probe_lists(q), k)
        _check_topk(ed, ei, wd, wi, scale=10.0)


# the slice's lists (1M rows in 256 lists of at most 4155 slots, 16
# probed) and the parity replay's (2000 rows in 48, 10 probed), at the k
# the paths use
@pytest.mark.parametrize("nlist,cap,nprobe,k,want", [
    (256, 4155, 16, 64, (4, 1039)),
    (256, 4155, 16, 10, (5, 831)),
    (48, 80, 10, 32, (1, 80)),
    (8, 5000, 2, 1, (132, 38)),
    (256, 4155, 64, 128, (1, 4155)),
    (300, 0, 5, 5, (1, 0))])
def test_ivf_lists_plan_at_the_main_path_shapes(nlist, cap, nprobe, k, want):
    """Runs of at least _LISTS_MIN_RUN * k slots for about
    _LISTS_TARGET_BLOCKS blocks, covering each list once, and no more than
    _MERGE_MAX_WIDTH partials a query for the merge where one run a list
    keeps under it."""
    nruns, run = tops.ivf_lists_plan(nlist, cap, nprobe, k)
    assert (nruns, run) == want
    assert nruns * run >= cap and (nruns - 1) * run < max(cap, 1)
    assert nruns == 1 or run >= tops._LISTS_MIN_RUN * k - 1
    assert nruns == 1 or nprobe * nruns * k <= tops._MERGE_MAX_WIDTH


def test_probed_table_gives_entries_naming_no_list_only_pad():
    inv = torch.tensor([[4, 7, -1], [1, -1, -1], [0, 2, 3]], dtype=torch.int32)
    probe = torch.tensor([[2, 0], [3, 1], [-1, 2]], dtype=torch.int32)
    assert tops.probed_table(inv, probe).tolist() == [
        [0, 2, 3, 4, 7, -1], [-1, -1, -1, 1, -1, -1], [-1, -1, -1, 0, 2, 3]]
    q = torch.zeros((3, 2))
    x = torch.arange(16, dtype=torch.float32).view(8, 2)
    gd, gi = tops.ivf_scan_lists(q, x, inv, probe, 4)
    assert gi.tolist() == [[0, 2, 3, 4], [1, -1, -1, -1], [0, 2, 3, -1]]
    assert torch.isinf(gd[1, 1:]).all() and torch.isinf(gd[2, 3])


@pytest.mark.parametrize("d,want", [(16, "ivf_scan_lists"), (128, "ivf_scan_lists"),
                                    (256, "ivf_scan_lists"), (257, "ivf_scan"),
                                    (1024, "ivf_scan"), (4096, "ivf_scan")])
def test_ivf_probe_takes_its_kernel_by_shape(d, want):
    """List-major up to 256 columns (its ring and queries fit shared memory
    there), the per-query kernel beyond."""
    assert tops.ivf_probe_kernel_for(d) == want


@pytest.mark.parametrize("b", [8, 64, 1, 200])
def test_short_tables_spread_over_warps_and_blocks(b):
    """The IVF-PQ re-rank's (B, 256) table at k 64: one block would walk it
    in four dependent rounds of 64 rows (8 warps, 8 rows in flight each);
    the plan spreads it over a cluster of 4 blocks of one round each, at
    every B (a cluster is a query's).  A long table takes the largest
    cluster, its runs walked in passes."""
    assert tops.ivf_scan_plan(b, 256, 64) == (4, 64, 4)
    blocks, run, cluster = tops.ivf_scan_plan(b, 66464, 64)
    assert blocks == cluster == tops.IVF_MAX_CLUSTER and run == -(-66464 // cluster)
    assert run >= tops.IVF_PASS
