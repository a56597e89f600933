"""The cached rows' slab built from a variable-width `torch.nonzero`: the
count is read back to the host, the ids cut to `cap` and padded with -1
there.  The fixed-width slab of `repro_torch.index.candidates._local_slab`
has to give its ids and distances bit for bit; the CPU tests and the card's
test hold it to them.  Imports torch and the port only."""

import torch

from repro_torch.core.costs import BIG_COST
from repro_torch.kernels import ops
from repro_torch.kernels.ref import smallest_k


def nonzero_slab(rs, x, catalog, cap: int, c_local: int, alive=None):
    """`_local_slab`'s arguments and outputs, with its id vector from
    `torch.nonzero`."""
    n = catalog.shape[0]
    cached = torch.nonzero(x > 0.5).flatten()[:cap]
    cached = torch.cat([cached, cached.new_full((cap - cached.shape[0],), -1)])
    safe = torch.clamp_min(cached, 0)
    d_loc = ops.pairwise_l2(rs, catalog[safe].contiguous())
    ok = cached >= 0
    if alive is not None:
        ok = ok & alive[safe]
    d_loc = torch.where(ok[None, :], d_loc, torch.full_like(d_loc, float("inf")))
    d_local, pos = smallest_k(d_loc, c_local)
    ids_local = torch.where(torch.isfinite(d_local), cached[pos], torch.full_like(pos, -1))
    lmiss = ids_local < 0
    ids_local = torch.where(lmiss, torch.full_like(ids_local, n), ids_local)
    d_local = torch.where(lmiss, torch.full_like(d_local, BIG_COST), d_local)
    return ids_local, d_local
