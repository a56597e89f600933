"""The cached rows' slab (`repro_torch.index.candidates._local_slab`) on the
CPU: its fixed-width (cap,) id vector, built on the device with no
read-back, gives bit for bit the ids and distances of the slab built from a
variable-width `torch.nonzero` (`torch_slab_ref`), and the reference's
`jnp.nonzero(size=cap, fill_value=-1)` slab.  Cases: no row held, fewer held rows than `cap`,
exactly `cap`, more than `cap` (the lowest ids are kept), and held rows
that are dead; through `_local_slab` itself, the static generator and the
mutable one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import IndexSpec as JSpec
from repro.index import build_index as jbuild
from repro.index import candidates as jcand
from repro.index.base import TINY_BUILD_KWARGS as TINY
from repro.index.exact import FlatIndex as JFlat
from repro_torch.core.costs import BIG_COST
from repro_torch.index import candidates as tcand
from repro_torch.index.base import IndexSpec, build_index
from repro_torch.index.exact import FlatIndex as TFlat
from torch_slab_ref import nonzero_slab

N, D, B = 600, 16, 8
H, C_REMOTE, C_LOCAL = 16, 12, 8
CAP = 2 * H + 64                       # `_local_cap(N, C_LOCAL, H)`
# held rows a case; "dead" holds rows of which every other one is dead
CASES = {"empty": 0, "fewer": 40, "cap": CAP, "more": 3 * CAP, "dead": 60}
RTOL = 1e-5


def _case(case: str, seed: int = 0):
    """(catalog, requests, x, alive, dead ids) of a case; alive is None
    where no row is dead.  Row i + N / 2 is row i again, so where both are
    held their distances tie and the ids' order decides."""
    rng = np.random.default_rng(seed)
    cat = rng.random((N, D), dtype=np.float32)
    cat[N // 2:] = cat[:N // 2]
    rs = rng.random((B, D), dtype=np.float32)
    held = rng.permutation(N)[:CASES[case]]
    x = np.zeros(N, np.float32)
    x[held] = 1.0
    if case != "dead":
        return cat, rs, x, None, np.zeros(0, np.int64)
    dead = np.sort(held[::2])
    alive = np.ones(N, bool)
    alive[dead] = False
    return cat, rs, x, alive, dead


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_bitwise(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _assert_close(got, want):
    """(ids, d, ...) of the port against the reference's: ids and validity
    equal, distances to RTOL."""
    gi, gd, *gv = (np.asarray(a) for a in got)
    wi, wd, *wv = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=RTOL)
    for g, w in zip(gv, wv):
        np.testing.assert_array_equal(g, w)


def _reference_local(cat, rs, x, alive, c_local):
    """The reference's local slab: its mutable assembly with every remote
    slot a miss, so the local columns are the `jnp.nonzero(size=cap,
    fill_value=-1)` slab's."""
    alive = np.ones(N, bool) if alive is None else alive
    ids_remote = jnp.full((B, C_REMOTE), -1, jnp.int32)
    d_remote = jnp.full((B, C_REMOTE), jnp.inf, jnp.float32)
    ids, d, _ = jcand._assemble_mutable_slab(
        jnp.array(rs), jnp.array(x), jnp.array(cat), jnp.array(alive), ids_remote, d_remote,
        c_local=c_local, cap=CAP, c_remote=C_REMOTE, rerank=False)
    return ids[:, C_REMOTE:], d[:, C_REMOTE:]


@pytest.mark.parametrize("case", list(CASES))
def test_local_slab_is_the_nonzero_slab_and_the_references(case):
    # c_local = CAP: every gathered row is an answer, so the kept rows show
    cat, rs, x, alive, dead = _case(case)
    assert tcand._local_cap(N, C_LOCAL, H) == CAP
    args = (_t(rs), _t(x), _t(cat), CAP, CAP, None if alive is None else _t(alive))
    got = tcand._local_slab(*args)
    _assert_bitwise(got, nonzero_slab(*args))
    _assert_close(got, _reference_local(cat, rs, x, alive, CAP))
    kept = np.setdiff1d(np.flatnonzero(x)[:CAP], dead)        # the lowest CAP held, live
    for row in got[0].numpy():
        assert sorted(row[row < N]) == kept.tolist()
    assert ((got[0] == N) == (got[1] == BIG_COST)).all()


def _generators(kind: str, cat, dead):
    """(port generator, reference generator, the slab's length) over a flat
    index: the static generators, or the mutable ones over an index whose
    rows `dead` are removed."""
    if kind == "static":
        return (tcand.index_candidate_fn_batched(TFlat(cat, device="cpu"), _t(cat), C_REMOTE,
                                                 C_LOCAL, h=H),
                jcand.index_candidate_fn_batched(JFlat(jnp.array(cat), kernel="xla"),
                                                 jnp.array(cat), C_REMOTE, C_LOCAL, h=H), N)
    port = build_index(IndexSpec("flat", dict(TINY["flat"])), cat, device="cpu")
    ref = jbuild(JSpec("flat", TINY["flat"]), jnp.asarray(cat))
    if dead.size:
        port.remove(dead)
        ref.remove(dead)
    assert port.capacity == ref.capacity
    return (tcand.mutable_index_candidate_fn(port, C_REMOTE, C_LOCAL, h=H),
            jcand.mutable_index_candidate_fn(ref, C_REMOTE, C_LOCAL, h=H), port.capacity)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", ["static", "mutable"])
def test_generators_serve_the_nonzero_slab_and_the_references(kind, case, monkeypatch):
    cat, rs, x, _, dead = _case(case)
    tfn, jfn, n = _generators(kind, cat, dead)
    x = np.concatenate([x, np.zeros(n - N, np.float32)])
    got = tfn(_t(rs), _t(x))
    _assert_close(got, jfn(jnp.array(rs), jnp.array(x)))
    monkeypatch.setattr(tcand, "_local_slab", nonzero_slab)
    _assert_bitwise(got, tfn(_t(rs), _t(x)))
    if kind == "mutable":
        assert not np.isin(got[0].numpy(), dead).any()
