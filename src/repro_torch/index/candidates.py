"""Candidate-set builder wiring an ANN index into the AÇAI policy (port of
`repro.index.candidates`, static catalog).

Remote candidates come from the remote-catalog index (with one exact
re-rank through the fused `ivf_scan` kernel for indexes whose distances
are approximate).  Local candidates are a top-k over only the cached rows:
x becomes an id list, those rows are gathered once for the whole batch,
and a (B, cap) `pairwise_l2` scan picks the candidates.
"""

from __future__ import annotations

import torch

from repro_torch.core.costs import BIG_COST
from repro_torch.core.policy import dedup_mask_batched
from repro_torch.kernels import ops
from repro_torch.kernels.ref import smallest_k


def _local_cap(n: int, c_local: int, h: int | None) -> int:
    """Bound on how many cached rows the local scan gathers: 2h + 64
    covers every rounding mode; without h a generous multiple of c_local.
    Past the cap the lowest-id cached rows are kept (quality loss, not an
    error)."""
    if h is not None:
        return min(n, 2 * h + 64)
    return min(n, max(8 * c_local, 512))


def index_candidate_fn_batched(index, catalog: torch.Tensor, c_remote: int,
                               c_local: int, h: int | None = None):
    """Build fn(rs (B, d), x (N,)) -> (ids (B, C), dists (B, C), valid (B, C))
    with C = c_remote + c_local: int64 candidate ids (n marks an invalid
    slot), float32 exact distances (BIG_COST on invalid slots), bool
    validity after cross-slab dedup."""
    n = catalog.shape[0]
    cap = _local_cap(n, c_local, h)
    rerank = not getattr(index, "exact_distances", False)

    def fn(rs: torch.Tensor, x: torch.Tensor):
        rs = rs.contiguous()
        d_remote, ids_remote = index.query(rs, c_remote)       # (B, c_remote)
        if rerank:
            # single exact re-rank of the retrieved ids; -1 misses stay -1
            d_remote, ids_remote = ops.ivf_scan_topk(
                rs, catalog, ids_remote.to(torch.int32).contiguous(), c_remote)
        ids_remote = ids_remote.long()
        rmiss = ids_remote < 0
        ids_remote = torch.where(rmiss, torch.full_like(ids_remote, n), ids_remote)
        d_remote = torch.where(rmiss, torch.full_like(d_remote, BIG_COST), d_remote)

        # local side: the cached rows gathered once for the whole batch.
        # torch.nonzero has a data-dependent size, so it reads the count
        # back to the host (one sync per step, where the reference pads
        # inside the trace with nonzero(size=cap, fill_value=-1))
        cached = torch.nonzero(x > 0.5).flatten()[:cap]
        cached = torch.cat([cached, cached.new_full((cap - cached.shape[0],), -1)])
        cached_embs = catalog[torch.clamp_min(cached, 0)].contiguous()   # (cap, d)
        d_loc = ops.pairwise_l2(rs, cached_embs)                          # (B, cap)
        d_loc = torch.where((cached >= 0)[None, :], d_loc,
                            torch.full_like(d_loc, float("inf")))
        d_local, pos = smallest_k(d_loc, c_local)
        ids_local = torch.where(torch.isfinite(d_local), cached[pos],
                                torch.full_like(pos, -1))
        lmiss = ids_local < 0
        ids_local = torch.where(lmiss, torch.full_like(ids_local, n), ids_local)
        d_local = torch.where(lmiss, torch.full_like(d_local, BIG_COST), d_local)

        ids = torch.cat([ids_remote, ids_local], dim=1)
        d = torch.cat([d_remote, d_local], dim=1)
        valid = dedup_mask_batched(ids, n)
        d = torch.where(valid, d, torch.full_like(d, BIG_COST))
        return ids, d, valid

    return fn
