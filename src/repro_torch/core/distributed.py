"""Distributed AÇAI on `torch.distributed` (port of `repro.core.distributed`):
the retrieval / caching step with the catalog and the fractional state y
sharded over a mesh's `model` axis and the request batch over `data`.

The mesh is a `torch.distributed.device_mesh.DeviceMesh` with axes
("data", "model") (`repro_torch.launch.mesh`); one process a rank, one
shard a rank.  Every rank holds its catalog block, rows [p n_s, (p + 1)
n_s) of the N = P n_s rows (p its `model` coordinate), and the same
blocks of y and x; every rank is handed the whole request batch and serves
its `data` slice of it.  One serve + update step per batch:

  1. each rank scans its block: the full (b, n_s) matrix on the
     `pairwise_l2` kernel, the `l2_topk` kernel (`scan_chunk > 0`), or the
     rank's own IVF lists (a `pairwise_l2` coarse quantizer, then the
     per-query `ivf_scan` kernel over the probed lists' ids), and takes a
     local top-C;
  2. ONE all-gather over `model` of a packed candidate payload [dist,
     id, y, x] (ids ride in float32 lanes, bit for bit) and a per-section
     re-merge by a stable sort (`kernels.ref.smallest_k`, the lax.top_k
     tie rule);
  3. gain and subgradient on the merged candidates (Eq. 55);
  4. the subgradients routed to their owners: one packed [g, id] gather
     over each batch axis of more than one rank (`all_gather_axes`, in
     the axes' row-major order; none on a one-rank batch), carrying the
     batch's per-request metrics with it, and the fixed-order scatter
     `policy.scatter_rows_sum`;
  5. the OMA step and the distributed capped-simplex projection: each
     rank's top-A heads and tail sum, ONE all-gather of P (A + 1) scalars,
     the water level solved on every rank from the same sorted heads;
  6. rounding on the rank's block of the step's N uniforms (every rank
     draws all N from the same seeded generator), and ONE all-reduce of
     the packed (fetched, occupancy) sums over `model`; DepRound couples
     the whole vector, so on the steps where it fires y is gathered.

Every collective goes through `all_gather` / `all_reduce` here, which
count their calls in `COLLECTIVES` (by primitive) and `COLLECTIVE_SITES`
(by primitive and purpose); `collectives_per_step` reads one call's.  The
exact step spends {"all_gather": 2, "all_reduce": 1} on a (1, P) mesh,
one gather more a batch axis of more than one rank (two over ("pod",
"data")), and the IVF / `scan_chunk` step one merge gather more (its
remote merge is sent before the cached-row scan).

On a (1, 1) mesh the exact, replay and mutable steps are bit for bit the
single-device `policy.make_step_batched` + exact candidates and
`policy.make_mutable_step`, given `top_a == cfg.oma.projection_topk`.

Tensors and groups must agree: CUDA tensors need an NCCL group, CPU
tensors a gloo one and meta tensors the fake backend of a world-less mesh
(`launch.mesh.fake_world`, which moves no data); a mismatch raises,
nothing is staged through the host.  Each counted call hands its
operand's bytes to the open cost records (`kernels.cost.add_collective`).

Over an axis of one rank a collective moves nothing: `all_gather`,
`all_reduce` and `reduce_scatter` then return the input (a view or the
tensor itself, detached; read it, do not write into it) and still count
the call at its site, so the counts are the same at any axis size.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import gain as gain_lib
from repro_torch.core import mirror as mirror_maps
from repro_torch.core import oma as oma_lib
from repro_torch.core import policy as policy_lib
from repro_torch.core import rounding as rounding_lib
from repro_torch.core.costs import BIG_COST, pairwise_dissimilarity
from repro_torch.core.projection import _negentropy_scale_from_sorted
from repro_torch.kernels import cost as kernel_cost
from repro_torch.kernels import ops
from repro_torch.kernels.ref import probed_table, smallest_k

# the largest per-query IVF table (nprobe x the longest list) the sharded
# probe takes: `ivf_scan`'s cluster plan at its widest, 16 blocks of five
# passes, the extent it was held to on the card
IVF_TABLE_MAX = ops.IVF_MAX_CLUSTER * 5 * ops.IVF_PASS


# ---------------------------------------------------------------------------
# Mesh arithmetic and the counted collectives
# ---------------------------------------------------------------------------

def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _axis_size(mesh, axes) -> int:
    names = mesh.mesh_dim_names
    total = 1
    for ax in _axes(axes):
        total *= mesh.size(names.index(ax))
    return total


def _axis_rank(mesh, axes) -> int:
    """This rank's coordinate along `axes` (row-major over several)."""
    names = mesh.mesh_dim_names
    r = 0
    for ax in _axes(axes):
        r = r * mesh.size(names.index(ax)) + mesh.get_local_rank(ax)
    return r


def _real_axes(mesh, axes) -> list:
    """The axes of `axes` with more than one rank, in their order."""
    return [ax for ax in _axes(axes) if _axis_size(mesh, ax) > 1]


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on: the CPU for a "cpu" mesh, the
    current CUDA device for a "cuda" one, the meta device on a world-less
    mesh (`launch.mesh.fake_world`: no peers, no data)."""
    from repro_torch import resolve_device

    if dist.get_backend() == FAKE_BACKEND:
        return torch.device("meta")
    return resolve_device(mesh.device_type)


# calls since the last reset, by primitive ("all_gather", "all_reduce",
# "reduce_scatter") and by (primitive, purpose): "merge", "route",
# "projection", "round_sums", "depround", "metrics" within a step, "regrid"
# on a growth or a compaction, "gather_rows" for a caller's gather of a
# sharded tensor; the expert-parallel MoE's "moe_weights" (fsdp gathers),
# "moe_ids", "moe_aux" and "moe_combine" (models/moe.py); the layout run's
# sites (`sharding/tp.py`), "attn_seq" among them (a decode's softmax
# partials over a sequence-sharded cache); a backward's collective at its
# forward's site + ".grad"
COLLECTIVES: Counter = Counter()
COLLECTIVE_SITES: Counter = Counter()
# one tensor in, the group's tensors concatenated out (newer PyTorch names
# all_gather_into_tensor all_gather_single)
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
# what the sharded paths' collectives run on (the dry-run's provenance
# record names it where the reference names its shard_map)
COLLECTIVE_LAYER = (f"repro_torch.core.distributed on torch.distributed."
                    f"{_ALL_GATHER.__name__} / all_reduce")


def reset_collectives() -> None:
    COLLECTIVES.clear()
    COLLECTIVE_SITES.clear()


# the backend of a world-less mesh (`launch.mesh.fake_world`): groups with
# no peers, for meta tensors only
FAKE_BACKEND = "fake"
# the backend each device's tensors need
_BACKEND_FOR = {"cuda": "nccl", "cpu": "gloo", "meta": FAKE_BACKEND}


def _group(mesh, axis: str, t: torch.Tensor, what: str):
    """The mesh's group of `axis`, whose backend must be the one `t`'s
    device takes: NCCL for CUDA, gloo for the CPU, and the fake backend
    (no peers, no data) for meta tensors, and for them only."""
    group = mesh.get_group(axis)
    backend = dist.get_backend(group)
    want = _BACKEND_FOR.get(t.device.type)
    if want is None or want not in backend:
        raise ValueError(
            f"{what}: a {t.device.type} tensor needs a {want} group; the mesh's "
            f"{axis!r} group is {backend!r} (nccl: a cuda mesh; gloo: a cpu mesh; "
            f"{FAKE_BACKEND}: a world-less mesh, meta tensors only)")
    return group


def _book(primitive: str, site: str, t: torch.Tensor) -> None:
    """Count a call of `primitive` at `site` on the operand `t`, and hand its
    bytes (a shard's, per call) to the open cost records."""
    COLLECTIVES[primitive] += 1
    COLLECTIVE_SITES[(primitive, site)] += 1
    kernel_cost.add_collective(primitive, t.numel() * t.element_size())


def all_gather(t: torch.Tensor, mesh, axis: str, site: str) -> torch.Tensor:
    """(P, *t.shape): `t` of every rank of `axis`, in rank order; one
    counted `all_gather`."""
    group = _group(mesh, axis, t, f"all_gather ({site})")
    size = _axis_size(mesh, axis)
    if size == 1:
        _book("all_gather", site, t)
        return t.detach().unsqueeze(0)
    flat = t.contiguous().reshape(-1)
    out = torch.empty(size * flat.numel(), dtype=t.dtype, device=t.device)
    if not t.is_meta:  # a meta tensor has no data to send
        _ALL_GATHER(out, flat, group=group)
    _book("all_gather", site, t)
    return out.view((size,) + tuple(t.shape))


def all_reduce(t: torch.Tensor, mesh, axis: str, site: str, op: str = "sum") -> torch.Tensor:
    """The sum (op "max": the maximum) of `t` over the ranks of `axis` (a
    new tensor; `t` itself, detached, over one rank); one counted
    `all_reduce`.  No gradient: the model's collectives under autograd
    are `reduce_partials`, `replicated_input` and `gather_shards`."""
    group = _group(mesh, axis, t, f"all_reduce ({site})")
    if _axis_size(mesh, axis) == 1:
        _book("all_reduce", site, t)
        return t.detach()
    out = t.detach().contiguous().clone()
    if not t.is_meta:
        dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=group)
    _book("all_reduce", site, t)
    return out


def all_gather_axes(t: torch.Tensor, mesh, axes, site: str) -> torch.Tensor:
    """(P, *t.shape): `t` of every rank of the axes `axes`, in their
    row-major rank order (`_axis_rank`'s), P the product of their sizes,
    as the reference's all-gather over a tuple of axes.  One counted
    `all_gather` an axis of more than one rank, the innermost first, so a
    batch over (pod, data) costs two calls where one axis costs one; no
    call where every axis has one rank."""
    g = t.detach().unsqueeze(0)
    for ax in reversed(_real_axes(mesh, axes)):
        g = all_gather(g, mesh, ax, site)
        g = g.reshape((-1,) + tuple(t.shape))
    return g


def all_reduce_axes(t: torch.Tensor, mesh, axes, site: str) -> torch.Tensor:
    """The sum of `t` over the ranks of the axes `axes`: one counted
    `all_reduce` an axis of more than one rank (`t` itself, detached,
    where there is none)."""
    out = t.detach()
    for ax in _real_axes(mesh, axes):
        out = all_reduce(out, mesh, ax, site)
    return out


def reduce_scatter(t: torch.Tensor, mesh, axis: str, dim: int, site: str) -> torch.Tensor:
    """This rank's block along `dim` of the sum of `t` over the ranks of
    `axis`; one counted `reduce_scatter`.  NCCL runs
    `reduce_scatter_tensor`; gloo has none, so on the CPU it is an
    all-reduce followed by the rank's slice (counted the same)."""
    group = _group(mesh, axis, t, f"reduce_scatter ({site})")
    n, r = _axis_size(mesh, axis), _axis_rank(mesh, axis)
    dim = dim % t.dim()
    if n == 1:
        _book("reduce_scatter", site, t)
        return t.detach()
    if t.is_meta:
        out = t.detach().narrow(dim, 0, t.shape[dim] // n).clone()
    elif "nccl" in dist.get_backend(group):
        src = t.detach().movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.reduce_scatter_tensor(out, src, group=group)
        out = out.movedim(0, dim)
    else:
        whole = t.detach().contiguous().clone()
        dist.all_reduce(whole, group=group)
        out = whole.narrow(dim, r * (t.shape[dim] // n), t.shape[dim] // n)
    _book("reduce_scatter", site, t)
    return out.contiguous()


class _ReducePartials(torch.autograd.Function):
    """Forward: the sum over `axis` of the ranks' partials; backward: the
    gradient unchanged (every rank's partial feeds the same sum)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, site):
        return all_reduce(t, mesh, axis, site)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None


class _ReplicatedInput(torch.autograd.Function):
    """Forward: the input unchanged (replicated over `axis`); backward: the
    sum over `axis` of the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, t, mesh, axis, site):
        ctx.args = (mesh, axis, site)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, site = ctx.args
        return all_reduce(grad, mesh, axis, site + ".grad"), None, None, None


class _GatherShards(torch.autograd.Function):
    """Forward: the whole tensor from the ranks' blocks along `dim` (an
    all-gather); backward: the rank's block of the sum of the ranks'
    gradients (`reduce_scatter`)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim, site):
        ctx.args = (mesh, axis, dim, site)
        g = all_gather(t, mesh, axis, site)
        return g[0] if g.shape[0] == 1 else torch.cat(list(g.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, dim, site = ctx.args
        return reduce_scatter(grad, mesh, axis, dim, site + ".grad"), None, None, None, None


class _GatherReplicated(_GatherShards):
    """Forward: `_GatherShards`' all-gather; backward: the rank's block of the
    gradient, no collective.  For a whole tensor that every rank of `axis`
    uses alike: each rank's gradient of it is then already the whole
    gradient, which a reduce-scatter would count once a rank."""

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, dim, _ = ctx.args
        width = grad.shape[dim] // _axis_size(mesh, axis)
        return (grad.narrow(dim, _axis_rank(mesh, axis) * width, width), None, None, None,
                None)


def reduce_partials(t: torch.Tensor, mesh, axis: str, site: str) -> torch.Tensor:
    """The sum over `axis` of each rank's partial `t` (all-reduce), whose
    backward passes the gradient through: a tensor-parallel layer's
    output, the loss's numerators over the batch axes."""
    return _ReducePartials.apply(t, mesh, axis, site)


def replicated_input(t: torch.Tensor, mesh, axis: str, site: str) -> torch.Tensor:
    """`t` (the same on every rank of `axis`) as the input of rank-partial
    work: forward the identity, backward the all-reduce of the ranks'
    partial gradients (counted at site + ".grad")."""
    return _ReplicatedInput.apply(t, mesh, axis, site)


def gather_shards(t: torch.Tensor, mesh, axis: str, dim: int, site: str) -> torch.Tensor:
    """The whole tensor from the ranks' blocks of dim `dim` over `axis`
    (rank order): the fsdp weight gather over `data`, a misaligned head
    projection's over `model`.  Backward: `reduce_scatter` (site +
    ".grad")."""
    return _GatherShards.apply(t, mesh, axis, dim % t.dim(), site)


def gather_replicated(t: torch.Tensor, mesh, axis: str, dim: int, site: str) -> torch.Tensor:
    """The whole tensor from the ranks' blocks of dim `dim` over `axis`,
    for a use that every rank of `axis` makes alike (a bias split over
    `model` whose matrix is whole there): backward the rank's block of the
    gradient, with no collective."""
    return _GatherReplicated.apply(t, mesh, axis, dim % t.dim(), site)


def collectives_per_step(fn: Callable, *args, **kwargs):
    """Run fn(*args, **kwargs) once and count its collectives: (total,
    {primitive: calls}).  The reference walks a traced program; the port
    counts the calls its wrappers make."""
    reset_collectives()
    fn(*args, **kwargs)
    counts = dict(COLLECTIVES)
    return sum(counts.values()), counts


def gather_rows(block: torch.Tensor, mesh, model_axis: str = "model") -> torch.Tensor:
    """The whole (N, ...) tensor from each rank's block along `model`, on
    every rank (a counted gather; every rank of the axis must call it)."""
    g = all_gather(block, mesh, model_axis, "gather_rows")
    return g.reshape((-1,) + tuple(block.shape[1:]))


def block_of(t: torch.Tensor, mesh, model_axis: str = "model") -> torch.Tensor:
    """This rank's block of rows of a whole (N, ...) tensor (N must divide
    by the `model` axis)."""
    p = _axis_size(mesh, model_axis)
    if t.shape[0] % p:
        raise ValueError(f"{t.shape[0]} rows must divide by the mesh's {p} "
                         f"{model_axis} shards")
    n_s = t.shape[0] // p
    r = _axis_rank(mesh, model_axis)
    return t[r * n_s:(r + 1) * n_s]


# ---------------------------------------------------------------------------
# Sharded IVF: a coarse quantizer and inverted lists per shard (local ids)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ShardedIVF:
    """Per-shard IVF structures, stacked along the shard axis as the
    reference lays them out.

    centroids: (P * nlist, d) float32 — shard p owns rows [p nlist, (p+1) nlist)
    invlists:  (P * nlist, cap) int32 — LOCAL row offsets into the owning
               catalog shard, -1 padded
    """

    centroids: torch.Tensor
    invlists: torch.Tensor
    nlist: int
    nprobe: int

    @property
    def n_shards(self) -> int:
        return self.centroids.shape[0] // self.nlist

    def shard(self, p: int):
        """(centroids (nlist, d), invlists (nlist, cap)) of shard p."""
        rows = slice(p * self.nlist, (p + 1) * self.nlist)
        return self.centroids[rows].contiguous(), self.invlists[rows].contiguous()

    def to(self, device) -> "ShardedIVF":
        return ShardedIVF(self.centroids.to(device), self.invlists.to(device),
                          self.nlist, self.nprobe)


def build_sharded_ivf(catalog, n_shards: int, *, nlist: int = 32, nprobe: int = 8,
                      train_iters: int = 12, seed: int = 0, init_rows=None,
                      device=None) -> ShardedIVF:
    """Train one IVF coarse quantizer per catalog shard (k-means over the
    shard's rows on the `pairwise_l2` kernel), as a rank would at scale.

    `init_rows[p]` holds shard p's nlist initial centroid rows (the
    reference draws them with `jax.random.choice(PRNGKey(seed + p), n_s,
    (nlist,), replace=False)`); without it they come from a CPU generator
    seeded `seed + p`.  `catalog` is the whole (N, d) catalog; each shard
    moves to `device` (the card by default) for its k-means."""
    from repro_torch import resolve_device
    from repro_torch.index.base import default_init_fn
    from repro_torch.index.ivf import build_invlists
    from repro_torch.index.kmeans import kmeans

    device = resolve_device(device)
    catalog = torch.as_tensor(catalog, dtype=torch.float32)
    n = catalog.shape[0]
    if n % n_shards:
        raise ValueError(f"catalog rows ({n}) must divide by {n_shards} shards")
    n_s = n // n_shards
    cents, tables = [], []
    for p in range(n_shards):
        shard = catalog[p * n_s:(p + 1) * n_s].to(device).contiguous()
        init = (init_rows[p] if init_rows is not None
                else default_init_fn(seed + p)(n_s, nlist))
        c, assign = kmeans(shard, nlist, train_iters, init_idx=init)
        cents.append(c)
        tables.append(build_invlists(assign.cpu().numpy(), nlist))
    cap = max(t.shape[1] for t in tables)
    tables = [np.pad(t, ((0, 0), (0, cap - t.shape[1])), constant_values=-1)
              for t in tables]
    return ShardedIVF(torch.cat(cents).contiguous(),
                      torch.from_numpy(np.concatenate(tables)).to(device).contiguous(),
                      nlist, nprobe)


def _check_ivf_matches_mesh(ivf: "ShardedIVF | None", n_model: int) -> None:
    """A ShardedIVF built for P shards serves only a P-way model axis: on
    another, a rank would read another shard's lists as its own local ids
    (wrong candidates, no shape error)."""
    if ivf is None:
        return
    if ivf.n_shards != n_model:
        raise ValueError(
            f"ShardedIVF was built for {ivf.n_shards} shards (centroids "
            f"{tuple(ivf.centroids.shape)}, nlist {ivf.nlist}) but the mesh's model "
            f"axis has {n_model} ranks — rebuild with build_sharded_ivf(catalog, "
            f"{n_model}, ...)")
    table = min(ivf.nprobe, ivf.nlist) * ivf.invlists.shape[1]
    if table > IVF_TABLE_MAX:
        raise ValueError(
            f"ShardedIVF's per-query table is {table} slots (nprobe {ivf.nprobe} x "
            f"the longest list, {ivf.invlists.shape[1]}), beyond the {IVF_TABLE_MAX} "
            f"of ivf_scan's cluster plan — use more lists or fewer probes")


def _local_scan(requests, catalog, c: int, scan_chunk: int, ivf_shard):
    """A rank's local top-c: (dists (b, c), local ids (b, c)).  The full
    (b, n_s) matrix on `pairwise_l2`, the `l2_topk` kernel (scan_chunk >
    0; chunked on the CPU), or the rank's probed lists on `ivf_scan`;
    underflowing slots come back as +inf / -1."""
    if ivf_shard is not None:
        centroids, invlists, nprobe = ivf_shard
        dc = pairwise_dissimilarity(requests, centroids)
        probe = smallest_k(dc, min(nprobe, centroids.shape[0]))[1]
        cand = probed_table(invlists, probe).to(torch.int32).contiguous()
        return ops.ivf_scan_topk(requests, catalog, cand, c)
    if scan_chunk:
        return ops.topk_l2_fused(requests, catalog, c, chunk=scan_chunk)
    return smallest_k(pairwise_dissimilarity(requests, catalog), c)


# ---------------------------------------------------------------------------
# Packed-collective building blocks
# ---------------------------------------------------------------------------

def _ids_to_f32(ids: torch.Tensor) -> torch.Tensor:
    """The int32 bits of `ids` as float32, so ids ride in the packed
    payload.  An id below 2^23 is a denormal: only data movement (cat,
    gather, collectives, selects) may touch such a lane, never arithmetic
    (a flush to zero would turn it into id 0)."""
    return ids.to(torch.int32).contiguous().view(torch.float32)


def _f32_to_ids(f: torch.Tensor) -> torch.Tensor:
    return f.contiguous().view(torch.int32)


def _candidate_payload(d, loc, miss, off: int, n: int, y_shard, x_shard):
    """One local candidate section packed as (b, c, 4) [d, id, y, x]: the
    proposing rank owns every row it proposes, so it attaches their y and
    x.  Miss slots (IVF underflow, dead rows) become (+inf, id n, 0, 0)."""
    n_s = y_shard.shape[0]
    loc = loc.long()
    safe = torch.clamp(loc, 0, n_s - 1)
    zero = torch.zeros((), dtype=y_shard.dtype, device=y_shard.device)
    gid = torch.where(miss, torch.full_like(loc, n), loc + off)
    return torch.stack([
        torch.where(miss, torch.full_like(d, float("inf")), d),
        _ids_to_f32(gid),
        torch.where(miss, zero, y_shard[safe]),
        torch.where(miss, zero, x_shard[safe])], dim=-1)


def _packed_merge(payload, counts, mesh, model_axis: str):
    """ONE all-gather of the (b, sum(counts), L) payload over `model`, then
    each section re-merged to its global top-counts[i] by a stable sort of
    column 0 (the others gathered along).  Returns (dists (b, c), [columns
    (b, c), ...]) a section.  At P = 1 the sections are sorted already and
    the stable sort keeps them: bitwise a no-op."""
    b, ctot, ncol = payload.shape
    n_model = _axis_size(mesh, model_axis)
    g = all_gather(payload, mesh, model_axis, "merge").transpose(0, 1)  # (b, P, ctot, L)
    outs = []
    off = 0
    for c in counts:
        sec = g[:, :, off:off + c].reshape(b, n_model * c, ncol)
        vals, pos = smallest_k(sec[..., 0], c)
        outs.append((vals, [torch.gather(sec[..., j], 1, pos) for j in range(1, ncol)]))
        off += c
    return outs


def _route_subgradients(g_cand, ids, valid, off: int, n_s: int, mesh, batch_axes,
                        n_batch: int, denom: float = 1.0, extra=None):
    """The batch's candidate subgradients summed into this rank's (n_s,)
    block of g: with a data axis, ONE packed [g, id] gather over it
    (invalid slots carry id -1, owned by no rank), which also carries
    `extra` (b, w) float32 rows (the batch's per-request metrics); on a
    one-rank data axis no exchange.  The scatter is `scatter_rows_sum`
    (fixed order).  Returns (g block, extra of the whole batch)."""
    ids_eff = torch.where(valid, ids, torch.full_like(ids, -1)) if valid is not None else ids
    if n_batch > 1:
        b, c = g_cand.shape
        parts = [g_cand, _ids_to_f32(ids_eff)] + ([] if extra is None else [extra])
        packed = all_gather_axes(torch.cat(parts, dim=1), mesh, batch_axes, "route")
        packed = packed.reshape(-1, packed.shape[-1])
        g_all, ids_all = packed[:, :c], _f32_to_ids(packed[:, c:2 * c])
        extra = None if extra is None else packed[:, 2 * c:]
    else:
        g_all, ids_all = g_cand, ids_eff
    mine = (ids_all >= off) & (ids_all < off + n_s)
    lidx = torch.clamp(ids_all.long() - off, 0, n_s - 1)
    vals = g_all / denom if denom != 1.0 else g_all
    return policy_lib.scatter_rows_sum(n_s, lidx, vals, mine), extra


def _distributed_projection(z, h, top_a: int, mesh, model_axis: str):
    """The negentropy Bregman projection (Sec. IV-F water filling) over the
    sharded z: each rank's top-A heads and exact tail sum, packed as one
    (A + 1,) row, ONE all-gather, the scale solved on every rank from the
    same sorted heads, applied locally.  At P = 1 this is
    `capped_simplex_negentropy_topk`, operation for operation.  Dead rows
    must carry z = 0 (the mutable caller masks them): a rank with fewer
    live rows than A pads its heads with zeros, which sort to the tail.
    With no feasible water level the scale falls back to 1."""
    z = torch.clamp_min(z, 0.0)
    ztop, idx = torch.topk(z, top_a, sorted=True)
    tail = torch.sum(z.index_fill(0, idx, 0.0))
    packed = all_gather(torch.cat([ztop, tail[None]]), mesh, model_axis, "projection")
    heads = packed[:, :top_a].reshape(-1)
    tails = torch.sum(packed[:, top_a])
    if packed.shape[0] > 1:
        heads = torch.sort(heads, descending=True).values
    s, ok = _negentropy_scale_from_sorted(heads, tails, h)
    s = torch.where(ok, s, torch.ones_like(s))
    return torch.clamp_max(z * s, 1.0)


def _pack_metrics(gain_int, gain_frac, cost, served_local) -> torch.Tensor:
    return torch.stack([gain_int, gain_frac, cost, served_local.to(torch.int32).view(
        torch.float32)], dim=1)


def _unpack_metrics(m: torch.Tensor):
    return m[:, 0], m[:, 1], m[:, 2], _f32_to_ids(m[:, 3])


# ---------------------------------------------------------------------------
# The roofline cell: stateless retrieval + OMA step on thresholded y
# ---------------------------------------------------------------------------

def make_retrieval_step(mesh, *, n_shard: int, d: int, c: int, k: int, c_f: float,
                        h: int, eta: float, top_a: int, batch_axes=("data",),
                        model_axis: str = "model", scan_chunk: int = 0,
                        ivf: ShardedIVF | None = None):
    """step(catalog block (n_s, d), y block (n_s,), requests (B, d)) ->
    (y_new block, answers (B, k), metrics): every rank gets the whole
    batch and serves its `data` slice.  scan_chunk > 0 scans on `l2_topk`;
    `ivf` probes each rank's own lists.  The answer holds the global ids
    of the k cheapest augmented copies a request (-1 where a starved IVF
    probe left a slot empty); metrics {"gain", "served_local"} are batch
    means (one all-reduce each over a data axis of more than one rank)."""
    n_model = _axis_size(mesh, model_axis)
    n_batch = _axis_size(mesh, batch_axes)
    n = n_shard * n_model
    _check_ivf_matches_mesh(ivf, n_model)
    ivf_shard = None
    if ivf is not None:
        ivf_shard = ivf.shard(_axis_rank(mesh, model_axis)) + (ivf.nprobe,)

    def step(catalog, y, requests):
        b = requests.shape[0] // n_batch
        i0 = _axis_rank(mesh, batch_axes) * b if n_batch > 1 else 0
        rs = requests[i0:i0 + b].contiguous()
        off = _axis_rank(mesh, model_axis) * n_shard
        # 1. local scan + top-c
        loc_d, loc_ids = _local_scan(rs, catalog, c, scan_chunk, ivf_shard)
        # 2. ONE packed merge over model: [d, id, y]
        payload = _candidate_payload(loc_d, loc_ids, loc_ids < 0, off, n, y, y)[..., :3]
        ((cand_d, (idf, y_cand)),) = _packed_merge(payload, (c,), mesh, model_axis)
        cand_ids = _f32_to_ids(idf)
        cand_d = torch.where(torch.isfinite(cand_d), cand_d,
                             torch.full_like(cand_d, BIG_COST))
        # 3. serve + subgradient
        served = gain_lib.serve_batch(cand_d, (y_cand > 0.5).to(cand_d.dtype), k, c_f)
        _, g_cand = gain_lib.gain_and_subgradient_batch(cand_d, y_cand, k, c_f)
        answers = torch.gather(cand_ids, 1, served.answer_ids)
        answers = torch.where(answers < n, answers, torch.full_like(answers, -1))
        # 4. route the subgradients (the answers ride along)
        g_shard, ans_all = _route_subgradients(g_cand, cand_ids, None, off, n_shard, mesh,
                                               batch_axes, n_batch,
                                               extra=_ids_to_f32(answers))
        # 5. OMA + distributed projection
        z = mirror_maps.dual_ascent_step(y, g_shard, eta, mirror_maps.NEGENTROPY)
        y_new = torch.clamp(_distributed_projection(z, float(h), top_a, mesh, model_axis),
                            1e-12, 1.0)
        gain = torch.mean(served.gain)
        local = torch.mean(torch.sum(served.from_cache, dim=1).to(torch.float32))
        if n_batch > 1:
            gain = all_reduce_axes(gain, mesh, batch_axes, "metrics") / n_batch
            local = all_reduce_axes(local, mesh, batch_axes, "metrics") / n_batch
        return y_new, _f32_to_ids(ans_all), {"gain": gain, "served_local": local}

    return step


def reference_step(catalog, y, requests, *, c, k, c_f, h, eta, top_a):
    """Single-device oracle with the same semantics (for tests)."""
    from repro_torch.core import projection

    cand_d, ids = smallest_k(pairwise_dissimilarity(requests, catalog), c)
    y_cand = y[ids]
    served = gain_lib.serve_batch(cand_d, (y_cand > 0.5).to(cand_d.dtype), k, c_f)
    _, g_cand = gain_lib.gain_and_subgradient_batch(cand_d, y_cand, k, c_f)
    g = policy_lib.scatter_rows_sum(y.shape[0], ids, g_cand,
                                    torch.ones_like(ids, dtype=torch.bool))
    z = y * torch.exp(torch.clamp(eta * g, -60.0, 60.0))
    y_new = projection.capped_simplex_negentropy_topk(z, h, top_a)
    answers = torch.gather(ids, 1, served.answer_ids)
    return torch.clamp(y_new, 1e-12, 1.0), answers


# ---------------------------------------------------------------------------
# The serving twin: sharded make_step_batched / make_replay_batched
# ---------------------------------------------------------------------------

def _step_uniforms(state: policy_lib.CacheState, n: int, u):
    """The step's N rounding uniforms: `u` when given (checked), else drawn
    from the state's generator, N at once on every rank."""
    if u is None:
        return torch.rand(n, generator=state.gen, device=state.y.device,
                          dtype=state.y.dtype)
    if u.shape[0] != n:
        raise ValueError(f"the sharded step takes the {n} uniforms of the whole "
                         f"state, got {u.shape[0]}")
    return u.to(device=state.y.device, dtype=state.y.dtype)


def _finish_sharded(cfg_up, state, u, batch: int, y_new, metrics, mesh,
                    model_axis: str):
    """Rounding on this rank's block of the uniforms, the (fetched,
    occupancy) sums by one all-reduce over `model`, the state advance; the
    twin of `policy.finish_step_batched`.  DepRound, which couples the
    whole vector, gathers y on the steps where it fires."""
    n_s = state.y.shape[0]
    off = _axis_rank(mesh, model_axis) * n_s
    u_blk = u[off:off + n_s]
    mode = cfg_up.oma.rounding
    if mode == "depround":
        if (-state.t) % cfg_up.oma.round_every < batch:
            y_all = all_gather(y_new, mesh, model_axis, "depround").reshape(-1)
            x_new = block_of(rounding_lib.depround(u, y_all), mesh, model_axis)
        else:
            x_new = state.x
    else:
        x_new = policy_lib._round_state(cfg_up, u_blk, y_new, state.y, state.x, state.t,
                                        width=batch)
    sums = all_reduce(torch.stack([rounding_lib.movement(x_new, state.x),
                                   torch.sum(x_new)]), mesh, model_axis, "round_sums")
    gain_int, gain_frac, cost, served_local = metrics
    fetched = torch.zeros((batch,), dtype=sums.dtype, device=state.y.device)
    fetched[-1] = sums[0]
    m = policy_lib.StepMetrics(gain_int=gain_int, gain_frac=gain_frac, cost=cost,
                               served_local=served_local, fetched=fetched,
                               occupancy=sums[1].expand(batch).clone())
    return policy_lib.CacheState(y_new, x_new, state.t + batch, state.gen), m


def _serve_and_update(cfg, cfg_up, y, x, ids, dcand, y_at, x_at, valid, off, n_s,
                      mesh, batch_axes, n_batch, batch, a, model_axis, alive=None):
    """Steps 3-5 on a merged candidate slab: serve, gain and subgradient,
    routing, OMA and the distributed projection.  Returns (y_new block,
    the whole batch's (gain_int, gain_frac, cost, served_local))."""
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    x_cand = torch.where(valid, x_at, zero)
    y_cand = torch.where(valid, y_at, zero)
    served = gain_lib.serve_batch(dcand, x_cand, cfg.k, cfg.c_f)
    gain_frac, g_cand = gain_lib.gain_and_subgradient_batch(dcand, y_cand, cfg.k, cfg.c_f)
    served_local = torch.sum(served.from_cache.to(torch.int32), dim=1)
    g_shard, extra = _route_subgradients(
        g_cand, ids, valid, off, n_s, mesh, batch_axes, n_batch, denom=float(batch),
        extra=_pack_metrics(served.gain, gain_frac, served.cost, served_local)
        if n_batch > 1 else None)
    metrics = (served.gain, gain_frac, served.cost, served_local) if extra is None \
        else _unpack_metrics(extra)
    z = mirror_maps.dual_ascent_step(y, g_shard, cfg_up.oma.eta, cfg.oma.mirror)
    if alive is not None:
        # dead rows carry z = 0: a rank tombstoned below top-A pads its heads
        z = torch.where(alive, z, zero)
    y_new = torch.clamp(_distributed_projection(z, cfg.h, a, mesh, model_axis),
                        oma_lib.Y_FLOOR, 1.0)
    if alive is not None:
        # the floor clip must not give removed rows mass again
        y_new = torch.where(alive, y_new, zero)
    return y_new, metrics


def _merged_slab(merged, b: int, cfg, n: int):
    """(ids, d, y, x, valid) of the merged (remote, local) sections, as
    `policy.exact_mutable_candidates` assembles them."""
    (d_remote, cols_r), (d_local, cols_l) = merged
    ids = torch.cat([_f32_to_ids(cols_r[0]), _f32_to_ids(cols_l[0])], dim=1)
    dcand = torch.cat([d_remote, d_local], dim=1)
    y_at = torch.cat([cols_r[1], cols_l[1]], dim=1)
    x_at = torch.cat([cols_r[2], cols_l[2]], dim=1)
    valid = policy_lib.dedup_mask_batched(ids, n)
    cached_ok = torch.cat([torch.ones((b, cfg.c_remote), dtype=torch.bool,
                                      device=ids.device), x_at[:, cfg.c_remote:] > 0.5],
                          dim=1)
    valid = valid & cached_ok
    dcand = torch.where(valid & torch.isfinite(dcand), dcand,
                        torch.full_like(dcand, BIG_COST))
    return ids, dcand, y_at, x_at, valid


def _exact_sections(rs, catalog, x, y, cfg, off: int, n: int, alive=None):
    """One (b, n_s) matrix feeds both sections, as
    `exact_mutable_candidates` does on the whole catalog; with `alive`
    dead rows are +inf and a remote slot past the live rows is a miss."""
    d_full = pairwise_dissimilarity(rs, catalog)
    inf = torch.full((), float("inf"), device=d_full.device)
    if alive is not None:
        d_full = torch.where(alive[None, :], d_full, inf)
    d_r, loc_r = smallest_k(d_full, cfg.c_remote)
    d_l, loc_l = smallest_k(torch.where(x[None, :] > 0.5, d_full, inf), cfg.c_local)
    miss_r = (~torch.isfinite(d_r) if alive is not None
              else torch.zeros(d_r.shape, dtype=torch.bool, device=d_r.device))
    no = torch.zeros(d_l.shape, dtype=torch.bool, device=d_l.device)
    return torch.cat([_candidate_payload(d_r, loc_r, miss_r, off, n, y, x),
                      _candidate_payload(d_l, loc_l, no, off, n, y, x)], dim=1)


def _sharded_setup(cfg, mesh, batch: int, model_axis: str, batch_axes):
    if cfg.oma.mirror != mirror_maps.NEGENTROPY:
        raise NotImplementedError("the sharded step requires the negentropy mirror map")
    n_model = _axis_size(mesh, model_axis)
    n_batch = _axis_size(mesh, batch_axes)
    if batch % n_batch:
        raise ValueError(
            f"batch size {batch} must divide by the mesh's batch axes {_axes(batch_axes)} "
            f"(total size {n_batch}); note serve_update (B = 1) only exists on meshes "
            f"with size-1 batch axes")
    return n_model, n_batch


def make_step_sharded(cfg: policy_lib.AcaiConfig, mesh, catalog: torch.Tensor, batch: int,
                      *, eta_scale: float | None = None, model_axis: str = "model",
                      batch_axes=("data",), scan_chunk: int = 0,
                      ivf: ShardedIVF | None = None, top_a: int | None = None) -> Callable:
    """The sharded mini-batch step: (state, requests (B, d), u=None) ->
    (state', StepMetrics (B,)), the multi-rank twin of
    `policy.make_step_batched` + `exact_candidate_fn_batched`.

    `catalog` is this rank's (n_s, d) block of the (P n_s, d) catalog, on
    the mesh's device; the state holds this rank's blocks of y and x;
    `requests` is the whole batch (every rank serves its `data` slice);
    `u` the step's N rounding uniforms (default: drawn from the state's
    generator).  Metrics cover the whole batch on every rank.

    Collectives a step: {"all_gather": 2, "all_reduce": 1} on a (1, P)
    mesh (the merge, the projection, the rounding sums), one gather more
    over a data axis (the routing); the IVF / scan_chunk path one merge
    gather more.  `top_a` defaults to `cfg.oma.projection_topk` (or 2h +
    64), at most n_s; with `cfg.oma.projection_topk == top_a` a (1, 1)
    mesh gives `make_step_batched`'s state and metrics bit for bit."""
    n_model, n_batch = _sharded_setup(cfg, mesh, batch, model_axis, batch_axes)
    n_s = catalog.shape[0]
    n = n_s * n_model
    _check_ivf_matches_mesh(ivf, n_model)
    me = _axis_rank(mesh, model_axis)
    off = me * n_s
    a = min(n_s, top_a or cfg.oma.projection_topk or 2 * cfg.h + 64)
    cfg_up = policy_lib.scaled_config(cfg, batch, eta_scale)
    ivf_shard = None if ivf is None else ivf.shard(me) + (ivf.nprobe,)
    cap = min(n_s, 2 * cfg.h + 64)
    b = batch // n_batch

    def candidates(rs, y, x):
        if scan_chunk == 0 and ivf is None:
            # one (b, n_s) matrix feeds both sections; one merge
            merged = _packed_merge(_exact_sections(rs, catalog, x, y, cfg, off, n),
                                   (cfg.c_remote, cfg.c_local), mesh, model_axis)
            return _merged_slab(merged, b, cfg, n)
        d_r, loc_r = _local_scan(rs, catalog, cfg.c_remote, scan_chunk, ivf_shard)
        # the remote merge goes first: its exchange runs beside the
        # cached-row scan below
        remote = _packed_merge(_candidate_payload(d_r, loc_r, loc_r < 0, off, n, y, x),
                               (cfg.c_remote,), mesh, model_axis)[0]
        # the rank's cached rows, at most 2h + 64 (the lowest ids first)
        cached = torch.nonzero(x > 0.5).flatten()[:cap]
        cached = torch.cat([cached, cached.new_full((cap - cached.shape[0],), -1)])
        d_loc = pairwise_dissimilarity(rs, catalog[torch.clamp_min(cached, 0)].contiguous())
        d_loc = torch.where((cached >= 0)[None, :], d_loc,
                            torch.full_like(d_loc, float("inf")))
        d_l, pos = smallest_k(d_loc, cfg.c_local)
        loc_l = torch.where(torch.isfinite(d_l), cached[pos], torch.zeros_like(pos))
        no = torch.zeros(d_l.shape, dtype=torch.bool, device=d_l.device)
        local = _packed_merge(_candidate_payload(d_l, loc_l, no, off, n, y, x),
                              (cfg.c_local,), mesh, model_axis)[0]
        return _merged_slab([remote, local], b, cfg, n)

    def step(state: policy_lib.CacheState, rs: torch.Tensor, u=None):
        if rs.shape[0] != batch:
            raise ValueError(f"the step was built for batch {batch}, got {rs.shape[0]}")
        i0 = _axis_rank(mesh, batch_axes) * b if n_batch > 1 else 0
        rs_b = rs[i0:i0 + b].contiguous()
        u = _step_uniforms(state, n, u)
        ids, dcand, y_at, x_at, valid = candidates(rs_b, state.y, state.x)
        y_new, metrics = _serve_and_update(cfg, cfg_up, state.y, state.x, ids, dcand,
                                           y_at, x_at, valid, off, n_s, mesh, batch_axes,
                                           n_batch, batch, a, model_axis)
        return _finish_sharded(cfg_up, state, u, batch, y_new, metrics, mesh, model_axis)

    return step


def make_replay_sharded(cfg: policy_lib.AcaiConfig, mesh, catalog: torch.Tensor,
                        batch: int, **kwargs) -> Callable:
    """The sharded whole-trace replay, twin of `policy.make_replay_batched`:
    (state, requests (T, d), uniforms=None) -> (state', StepMetrics (T,)),
    `uniforms` one row of N a step."""
    return policy_lib.make_replay_from_step(
        make_step_sharded(cfg, mesh, catalog, batch, **kwargs), batch)


# ---------------------------------------------------------------------------
# Sharded churn: the mutable catalog on a mesh
# ---------------------------------------------------------------------------

def make_mutable_step_sharded(cfg: policy_lib.AcaiConfig, mesh, batch: int, *,
                              eta_scale: float | None = None, model_axis: str = "model",
                              batch_axes=("data",), top_a: int | None = None) -> Callable:
    """The mutable catalog's sharded step: (state, requests (B, d), catalog
    block (n_s, d), alive block (n_s,), u=None) -> (state', StepMetrics
    (B,)).  The slab block and its liveness are arguments, so adds,
    removals, growth and compaction change only their values.  Dead rows
    are +inf in the scan, carry z = 0 into the projection, and stay at y =
    0 after it.  Collectives: those of the static exact step.  On a (1, 1)
    mesh with `cfg.oma.projection_topk == top_a`: bit for bit
    `exact_mutable_candidates` + `make_mutable_step`."""
    n_model, n_batch = _sharded_setup(cfg, mesh, batch, model_axis, batch_axes)
    cfg_up = policy_lib.scaled_config(cfg, batch, eta_scale)
    b = batch // n_batch

    def step(state: policy_lib.CacheState, rs, catalog, alive, u=None):
        n_s = catalog.shape[0]
        n = n_s * n_model
        off = _axis_rank(mesh, model_axis) * n_s
        a = min(n_s, top_a or cfg.oma.projection_topk or 2 * cfg.h + 64)
        i0 = _axis_rank(mesh, batch_axes) * b if n_batch > 1 else 0
        rs_b = rs[i0:i0 + b].contiguous()
        u = _step_uniforms(state, n, u)
        merged = _packed_merge(_exact_sections(rs_b, catalog, state.x, state.y, cfg, off, n,
                                               alive),
                               (cfg.c_remote, cfg.c_local), mesh, model_axis)
        ids, dcand, y_at, x_at, valid = _merged_slab(merged, b, cfg, n)
        y_new, metrics = _serve_and_update(cfg, cfg_up, state.y, state.x, ids, dcand,
                                           y_at, x_at, valid, off, n_s, mesh, batch_axes,
                                           n_batch, batch, a, model_axis, alive=alive)
        return _finish_sharded(cfg_up, state, u, batch, y_new, metrics, mesh, model_axis)

    return step


# ---------------------------------------------------------------------------
# Owner-shard mutation routing: global-id arithmetic over contiguous blocks
# ---------------------------------------------------------------------------

def owner_shard(ids, cap: int, n_model: int) -> np.ndarray:
    """Owning shard of each global slab row: shard p owns the block [p cap
    / P, (p + 1) cap / P), so routing is arithmetic, as long as the
    capacity stays a multiple of the mesh (the growth and compaction
    round-ups keep it so)."""
    if cap % n_model:
        raise ValueError(f"slab capacity {cap} must divide by the mesh's {n_model} "
                         f"model shards")
    return np.asarray(ids, np.int64) // (cap // n_model)


def route_ids_by_owner(ids, cap: int, n_model: int):
    """[(shard, ids np.int32), ...] in ascending shard order, each subset in
    the batch's order; together a permutation of the input.  At P = 1 the
    one group is the input."""
    ids = np.atleast_1d(np.asarray(ids, np.int32))
    own = owner_shard(ids, cap, n_model)
    return [(int(p), ids[own == p]) for p in np.unique(own)]


def regrid(blocks, old_cap: int, new_cap: int, mesh, model_axis: str = "model", rows=None):
    """Move rows to their owners after the capacity changes from `old_cap`
    to `new_cap` (a growth, or a compaction when `rows` (n_live,) int64
    lists the old rows that become rows 0..n_live-1): ONE all-gather of
    this rank's old blocks packed as float32 columns (site "regrid"),
    then the new block cut out.  `blocks` are (old_cap / P, ...) tensors of
    float32 or bool; new rows are 0 / False.  Never called by a step."""
    p = _axis_size(mesh, model_axis)
    if new_cap % p:
        raise ValueError(f"slab capacity {new_cap} must divide by the mesh's {p} "
                         f"model shards")
    widths = [1 if t.dim() == 1 else t.shape[1] for t in blocks]
    packed = torch.cat([t.reshape(t.shape[0], -1).to(torch.float32) for t in blocks], dim=1)
    whole = all_gather(packed, mesh, model_axis, "regrid").reshape(old_cap, -1)
    if rows is not None:
        whole = whole[rows]
    blk = new_cap // p
    lo = _axis_rank(mesh, model_axis) * blk
    out = torch.zeros((blk, whole.shape[1]), dtype=torch.float32, device=whole.device)
    hi = min(whole.shape[0], lo + blk)
    if hi > lo:
        out[:hi - lo] = whole[lo:hi]
    res, c = [], 0
    for t, w in zip(blocks, widths):
        col = out[:, c:c + w]
        col = col[:, 0] if t.dim() == 1 else col
        res.append(col > 0.5 if t.dtype == torch.bool else col.to(t.dtype).contiguous())
        c += w
    return res


def sharded_slab_append(emb, valid, n_slots: int, vectors, mesh, *, carry=(),
                        model_axis: str = "model"):
    """`index.base.slab_append` on a slab sharded over `model`: emb (cap /
    P, d) and valid (cap / P,) are this rank's blocks.  The appended rows
    [n_slots, n_slots + B) split at block boundaries into runs, each
    written by its owner; growth follows the single-device doubling
    schedule on the padded write windows, rounded up to a multiple of P,
    and moves rows to their new owners (`regrid`, with `carry`: the
    caller's (cap / P,) row-aligned blocks, such as y and x, which grow
    with zeros).  At P = 1 this is `slab_append`, growth included.

    Returns (emb', valid', ids np.int32 arange(n_slots, n_slots + B),
    carry')."""
    from repro_torch.index.base import bucket_width, grow_capacity, run_device

    p = _axis_size(mesh, model_axis)
    vec = torch.atleast_2d(torch.as_tensor(vectors, dtype=torch.float32)).to(emb.device)
    b = vec.shape[0]
    old_cap = cap = emb.shape[0] * p
    while True:
        # split into per-block runs, then check each run's padded write
        # window against the capacity; growth moves the block boundaries,
        # so re-split until the layout holds
        block = cap // p
        runs, start = [], 0
        while start < b:
            row = n_slots + start
            run = min(b - start, (row // block + 1) * block - row)
            runs.append((row, run))
            start += run
        need = max(row + bucket_width(run) for row, run in runs)
        if need <= cap:
            break
        cap = grow_capacity(0, need, cap)
        cap += (-cap) % p
    carry = tuple(carry)
    if cap != old_cap:
        emb, valid, *grown = regrid([emb, valid, *carry], old_cap, cap, mesh, model_axis)
        carry = tuple(grown)
    block = cap // p
    lo = _axis_rank(mesh, model_axis) * block
    for row, run in runs:
        if row // block != lo // block:
            continue
        src = vec[row - n_slots:row - n_slots + run]

        def write(emb, valid, src, r=row - lo, m=run):
            emb[r:r + m] = src
            valid[r:r + m] = True

        run_device(write, emb, valid, src)
    return emb, valid, np.arange(n_slots, n_slots + b, dtype=np.int32), carry
