"""The cached rows' slab reads nothing back on the card: one call of the
static candidate generator at the benchmark's closed cells' sizes (1M x
128, a batch of 512, h 400; the flat and the IVF index) runs under CUDA's
sync debug mode "error", all but the index query's finite check, and gives
bit for bit the ids and distances it gives with the slab built from a
variable-width `torch.nonzero` (`torch_slab_ref`).  Once with the cache's
own state, once with more rows held than the slab's width.

    python -m pytest -q tests/test_torch_local_slab_chip.py -m chip -s   (on a CUDA card)
"""

from __future__ import annotations

import pytest
import torch

from portbench import bench
from portbench.systems import acai
from repro_torch.index import base, candidates, exact, ivf
from torch_slab_ref import nonzero_slab

CELLS = ("sift1m_flat.batch512", "sift1m_ivf.batch512")
SEED = 2 ** 32 + 33


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip: "
                    "python -m pytest tests/test_torch_local_slab_chip.py -m chip)")
    return torch.device("cuda", 0)


def _strict(fn, *args):
    """fn(*args) under sync debug mode "error" (a read-back raises), with
    the finite check's read-back let through."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _finite_check_let_through(rs, where):
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("default")
    try:
        base.check_finite_queries(rs, where)
    finally:
        torch.cuda.set_sync_debug_mode(mode)


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_the_slab_raises_no_sync(cell, card, monkeypatch):
    spec = bench.Spec(cell)
    system = acai.System(spec.config, SEED, card)
    cache = system.cache
    fn, n = cache._fn_batched, system.catalog.shape[0]
    cap = candidates._local_cap(n, cache.cfg.c_local, cache.cfg.h)
    gen = torch.Generator(device=card).manual_seed(SEED)
    b = spec.mix["arrivals"]["batch"]
    rs = system.catalog[torch.randperm(n, generator=gen, device=card)[:b]].contiguous()
    over = torch.zeros(n, device=card)
    over[torch.randperm(n, generator=gen, device=card)[:3 * cap]] = 1.0
    for mod in (exact, ivf):
        monkeypatch.setattr(mod, "check_finite_queries", _finite_check_let_through)
    for name, x in (("state", cache.state.x), ("over cap", over)):
        fn(rs, x)                                   # built and warm
        got = _strict(fn, rs, x)
        with monkeypatch.context() as m:
            m.setattr(candidates, "_local_slab", nonzero_slab)
            want = fn(rs, x)
        held = int((x > 0.5).sum())
        print(f"{cell} {name}: {held} rows held, width {cap}: no sync; "
              f"slab equal to the nonzero slab: "
              f"{all(torch.equal(g, w) for g, w in zip(got, want))}")
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    system.release()
