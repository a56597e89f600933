"""Candidate-set generators wiring an ANN index into the AÇAI policy (port of
`repro.index.candidates`).

Remote candidates come from the remote-catalog index (with one exact
re-rank through the fused `ivf_scan` kernel for indexes whose distances
are approximate).  Local candidates are a top-k over only the cached rows:
x becomes an id list, those rows are gathered once for the whole batch,
and a (B, cap) `pairwise_l2` scan picks the candidates.

On a mutable catalog (`mutable_index_candidate_fn`) the generator reads
the index's slab, mask and capacity at every call, the re-rank folds
tombstones to -1 slots, and the local side skips dead cached rows.
"""

from __future__ import annotations

import torch

from repro_torch import spans
from repro_torch.core.costs import BIG_COST
from repro_torch.core.policy import dedup_mask_batched, per_request_view
from repro_torch.kernels import ops
from repro_torch.kernels.ref import smallest_k

_REMOTE, _LOCAL, _ASSEMBLE = (spans.span(f"candidates.{p}")
                              for p in ("remote", "local", "assemble"))


def _local_cap(n: int, c_local: int, h: int | None) -> int:
    """Bound on how many cached rows the local scan gathers: 2h + 64
    covers every rounding mode; without h a generous multiple of c_local.
    Past the cap the lowest-id cached rows are kept (quality loss, not an
    error)."""
    if h is not None:
        return min(n, 2 * h + 64)
    return min(n, max(8 * c_local, 512))


def _remote_slab(rs, catalog, d_remote, ids_remote, c_remote: int, rerank: bool,
                 alive=None):
    """The remote candidates as (ids (B, c_remote) int64, d): one exact
    re-rank through the fused `ivf_scan` kernel for approximate indexes
    (tombstones folded to -1 there), dead ids dropped otherwise; a miss
    becomes id n, BIG_COST."""
    n = catalog.shape[0]
    if rerank:
        d_remote, ids_remote = ops.ivf_scan_topk(
            rs, catalog, ids_remote.to(torch.int32).contiguous(), c_remote, valid=alive)
    elif alive is not None:
        # the index masks tombstones itself; kept for indexes that do not
        safe = torch.clamp(ids_remote.long(), 0, n - 1)
        dead = (ids_remote >= 0) & ~alive[safe]
        ids_remote = torch.where(dead, torch.full_like(ids_remote, -1), ids_remote)
        d_remote = torch.where(dead, torch.full_like(d_remote, float("inf")), d_remote)
    ids_remote = ids_remote.long()
    rmiss = ids_remote < 0
    ids_remote = torch.where(rmiss, torch.full_like(ids_remote, n), ids_remote)
    d_remote = torch.where(rmiss, torch.full_like(d_remote, BIG_COST), d_remote)
    return ids_remote, d_remote


def _local_slab(rs, x, catalog, cap: int, c_local: int, alive=None):
    """The cached rows' candidates (ids (B, c_local) int64, d): the rows x
    holds gathered once for the whole batch (at most `cap`, the lowest ids
    first) and scanned by one (B, cap) `pairwise_l2` launch; with `alive`,
    dead rows are skipped.  A miss becomes id n, BIG_COST.  The gathered
    ids are a fixed-width (cap,) vector built on the device, -1 past the
    held rows, as the reference's `jnp.nonzero(size=cap, fill_value=-1)`:
    nothing is read back, so the host goes on dispatching while the remote
    scan runs."""
    n = catalog.shape[0]
    cached = torch.nonzero_static(x > 0.5, size=cap, fill_value=-1).flatten()
    safe = torch.clamp_min(cached, 0)
    cached_embs = catalog[safe].contiguous()                           # (cap, d)
    d_loc = ops.pairwise_l2(rs, cached_embs)                          # (B, cap)
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


def _assemble(ids_remote, d_remote, ids_local, d_local, n: int):
    ids = torch.cat([ids_remote, ids_local], dim=1)
    d = torch.cat([d_remote, d_local], dim=1)
    valid = dedup_mask_batched(ids, n)
    d = torch.where(valid, d, torch.full_like(d, BIG_COST))
    return ids, d, valid


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
        with _REMOTE:
            d_remote, ids_remote = index.query(rs, c_remote)   # (B, c_remote)
            remote = _remote_slab(rs, catalog, d_remote, ids_remote, c_remote, rerank)
        with _LOCAL:
            local = _local_slab(rs, x, catalog, cap, c_local)
        with _ASSEMBLE:
            return _assemble(*remote, *local, n)

    return fn


def index_candidate_fn(index, catalog: torch.Tensor, c_remote: int, c_local: int,
                       h: int | None = None):
    """Per-request view of `index_candidate_fn_batched` (B = 1)."""
    return per_request_view(index_candidate_fn_batched(index, catalog, c_remote, c_local,
                                                       h=h))


def mutable_index_candidate_fn(index, c_remote: int, c_local: int,
                               h: int | None = None):
    """The candidate generator over a mutable index: the same slab as
    `index_candidate_fn_batched`, with the index's current slab
    (`embeddings`, N = its capacity) and mask (`valid`) read at every call,
    so it follows adds, removes, refreshes, growth and compaction.
    Tombstoned rows resolve to invalid slots on both sides."""
    rerank = not getattr(index, "exact_distances", False)

    def fn(rs: torch.Tensor, x: torch.Tensor):
        rs = rs.contiguous()
        with _REMOTE:
            d_remote, ids_remote = index.query(rs, c_remote)
            catalog, alive = index.embeddings, index.valid
            remote = _remote_slab(rs, catalog, d_remote, ids_remote, c_remote, rerank, alive)
        with _LOCAL:
            cap = _local_cap(index.capacity, c_local, h)
            local = _local_slab(rs, x, catalog, cap, c_local, alive)
        with _ASSEMBLE:
            return _assemble(*remote, *local, catalog.shape[0])

    return fn
