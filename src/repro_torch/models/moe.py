"""Mixture-of-Experts layer (port of `repro.models.moe`): top-k routing, the
capacity-bounded scatter dispatch into an (E, C, d) expert buffer, and
the expert-parallel form over a mesh.

Covers mixtral (8 experts, top-2), jamba (16, top-2) and deepseek-v3 (1
shared + 256 routed, top-8, sigmoid scoring).  The reference computes the
expert products as einsums outside any Pallas kernel; here they are
batched matmuls over the stacked expert weights.

Numerics kept from the reference, so the same slots drop and the same
sums come out:
  - scores are a sigmoid when cfg.attn_type == "mla", else a softmax, of
    float32 router logits; the top k are taken by a stable sort, ties to
    the lower expert id first, as `lax.top_k`;
  - a slot's position in its expert's buffer is the running count of the
    (token, slot) pairs before it in token-major order; slots at or past
    the capacity drop;
  - a token's k expert outputs are summed from zero in slot order in the
    model's dtype (the reference's scatter-add applies its updates in
    that order), never through atomics.

The load-balance loss is Switch's (fraction dot mean probability).

`moe_ffn` picks the reference's form (`src/repro/models/moe.py:221-229`):
with no mesh context open, the single-stage dispatch, or the per-block
one when cfg.moe_dp > 1 divides the tokens; under `sharding.ctx`'s mesh
context, the mesh form.  There a rank holds its data shard of the tokens
(replicated over `model`), or the whole batch where the context says so
(`ctx.batch_whole`: then routed as the unmeshed layer routes it, with no
exchange over the batch axes and the aux not averaged over copies), and
its block of the layer
(`convert.moe_block` / `lm_params_block`; under cfg.fsdp its `data` slice
of d in router, wi, wg and wo, gathered before use).  Where E divides the
`model` axis a rank holds E / n_model experts (expert parallelism); else
every expert and its block of the expert FFN dim, (None, fsdp, "model") /
(None, "model", fsdp) by the specs (the reference's TP inside experts).
`moe_local` is one rank's share of the shard_map branch with no
collective, and `moe_share` the rank's share of every other call; `moe_ffn`
wraps the rank's share with the counted collectives of
`core/distributed.py`:
  - the shard_map branch (expert parallel, moe_dp > 1 divides the GLOBAL
    token count): capacity and positions per (data shard, local expert),
    the aux the per-shard Switch loss averaged over the batch axes (one
    all-reduce a batch axis of more than one rank, at least one);
  - every other call (decode's B tokens, and TP inside experts): the
    reference's unmeshed dispatch over the global token order, data rank
    first, in moe_dp blocks when moe_dp > 1 divides the tokens (the
    two-stage form) else one (the single-stage form), capacity and
    positions counted a block (the (t_local, k) expert ids gathered over
    the batch axes of more than one rank, one all-gather each, in their
    row-major order), the rank's expert buffer only its own slots' rows
    (`moe_share`); the aux the formula over all tokens (the shards'
    first-choice fractions and mean probabilities all-reduced, as the
    aux above);
  - both: the (t_local, d) partials all-reduced over `model` in the
    model's dtype, the shared experts (an MLP under the mesh's layout)
    added after the sum.
The collectives carry gradients: the tokens and the gates enter the
rank's experts as replicated inputs (their partial gradients summed over
`model`), the partials' sum passes its gradient through, and the aux
loss's sums over the batch keep each rank's share.  At data 1 the
expert-parallel form equals the single-stage `moe_ffn` bit for bit at
top-2: the same capacity and slot order, and at most two nonzero
partials a token.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import ctx as mesh_ctx
from repro_torch.sharding import tp


class MoE(nn.Module):
    """router (d, E) float32; stacked experts wi / wg (E, d, f), wo (E, f, d)
    in cfg.dtype; `shared` an MLP of width f * n_shared_experts when the
    config has shared experts."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        dt = L.dtype_of(cfg)
        d, e = cfg.d_model, cfg.n_experts
        e_ff = cfg.moe_d_ff or cfg.d_ff
        self.router = nn.Parameter(L.dense_init(generator, d, e, torch.float32, device))
        self.wi = nn.Parameter(L.normal_init(generator, (e, d, e_ff), d ** -0.5, dt, device))
        self.wg = nn.Parameter(L.normal_init(generator, (e, d, e_ff), d ** -0.5, dt, device))
        self.wo = nn.Parameter(L.normal_init(generator, (e, e_ff, d), e_ff ** -0.5, dt,
                                             device))
        if cfg.n_shared_experts:
            self.shared = L.init_mlp(generator, cfg, device, e_ff * cfg.n_shared_experts)


def init_moe(generator: torch.Generator, cfg: ModelConfig, device) -> MoE:
    return MoE(cfg, generator, device)


def capacity(t: int, cfg: ModelConfig) -> int:
    """Slots an expert's buffer holds for t tokens: t * k when dropless
    (capacity_factor <= 0), else (t k cf) // E floored at min(t, 8), so a
    decode batch never rounds to a one-token capacity."""
    k = cfg.experts_per_token
    if cfg.capacity_factor <= 0:
        return t * k
    return int(max((t * k * cfg.capacity_factor) // cfg.n_experts, min(t, 8)))


def route(p, xf: torch.Tensor, cfg: ModelConfig):
    """(..., T, d) tokens -> (router logits (..., T, E) float32, gates
    (..., T, k) float32 normalised to sum 1, expert ids (..., T, k)).
    `p` is an MoE layer or its (d, E) router."""
    router = p if isinstance(p, torch.Tensor) else p.router
    logits = xf.float() @ router
    if cfg.attn_type == "mla":  # deepseek-style sigmoid scoring
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    k = cfg.experts_per_token
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    gate, eidx = vals[..., :k], idx[..., :k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return logits, gate, eidx


def slot_positions(flat_e: torch.Tensor, e: int, mine: torch.Tensor | None = None):
    """Position of each flat (token, slot) pair in its expert's buffer: the
    count of earlier pairs routed to the same expert (cumsum over the
    flat slots, token-major).  flat_e (..., T*k) -> (..., T*k) int64.
    With `mine` (a mask of the slots this rank's experts take), only those
    count, and the others get -1."""
    onehot = nn.functional.one_hot(flat_e, e)
    if mine is not None:
        onehot = onehot * mine[..., None]
    return (torch.cumsum(onehot, dim=-2) * onehot).sum(-1) - 1


def expert_ffn(wi, wg, wo, buf: torch.Tensor) -> torch.Tensor:
    """SwiGLU of each expert on its buffer: (..., E, C, d) -> (..., E, C, d)."""
    hidden = nn.functional.silu(torch.matmul(buf, wg)) * torch.matmul(buf, wi)
    return torch.matmul(hidden, wo)


def _aux_loss(logits: torch.Tensor, eidx: torch.Tensor, e: int) -> torch.Tensor:
    """Switch's load-balance loss: E * sum_e f_e * mean prob_e, f_e the share
    of tokens whose first choice is e.  logits (T, E), eidx (T, k)."""
    probs = torch.softmax(logits, dim=-1)
    f = nn.functional.one_hot(eidx[:, 0], e).float().mean(0)
    return e * torch.sum(f * probs.mean(0))


def _combine(out_buf, fe, pos, keep, gate, dtype):
    """Sum of a token's k slots from zero in slot order j = 0..k-1: fe, pos,
    keep (T, k); gate (T, k) float32; out_buf (E, C, d) -> (T, d)."""
    acc = torch.zeros((fe.shape[0], out_buf.shape[-1]), dtype=dtype, device=out_buf.device)
    for j in range(fe.shape[1]):
        g = out_buf[fe[:, j], pos[:, j]]
        g = torch.where(keep[:, j, None], g, torch.zeros_like(g))
        acc = acc + g * gate[:, j, None].to(dtype)
    return acc


def _expert_sum(xf, fe, pos, keep, gate, wi, wg, wo, cap: int):
    """The kept slots of T tokens through experts wi / wg / wo: fe, pos,
    keep (T, k) expert ids (into wi's first dim), buffer positions and the
    kept mask, gate (T, k) float32 -> each token's gated sum of its kept
    slots (T, d)."""
    t, k = fe.shape
    tok = torch.arange(t, device=xf.device).repeat_interleave(k)
    buf = torch.zeros((wi.shape[0], cap + 1, xf.shape[-1]), dtype=xf.dtype, device=xf.device)
    # a kept slot's (expert, position) is its own, so the writes never meet;
    # every other slot writes row `cap`, which no expert reads (a plain
    # scatter: no accumulation serialised on the dropped slots' rows)
    slot = torch.where(keep, pos, cap)
    buf.index_put_((fe.reshape(-1), slot.reshape(-1)), xf[tok])
    out_buf = expert_ffn(wi, wg, wo, buf[:, :cap])            # (E, C, d)
    return _combine(out_buf, fe, pos.clamp(0, cap - 1), keep, gate, xf.dtype)


def _moe_two_stage(p: MoE, xf: torch.Tensor, cfg: ModelConfig):
    """The reference's per-data-shard dispatch (cfg.moe_dp blocks of
    tokens, positions and capacity counted within each block), taken when
    moe_dp > 1 and no mesh is active.  xf (T, d) -> ((T, d), aux)."""
    t, d = xf.shape
    dp = cfg.moe_dp
    e, k = cfg.n_experts, cfg.experts_per_token
    tl = t // dp
    xb = xf.reshape(dp, tl, d)
    logits, gate, eidx = route(p, xb, cfg)                    # (dp, tl, ·)
    capl = capacity(tl, cfg)
    pos = slot_positions(eidx.reshape(dp, tl * k), e).reshape(dp, tl, k)
    out = torch.cat([_expert_sum(xb[i], eidx[i], pos[i], pos[i] < capl, gate[i], p.wi, p.wg,
                                 p.wo, capl) for i in range(dp)])
    if cfg.n_shared_experts:
        out = out + L.mlp(p.shared, xf)
    return out, _aux_loss(logits.reshape(t, e), eidx.reshape(t, k), e)


def _local_experts(eidx, my_model_rank: int, e_loc: int):
    """Expert ids (T, k) -> (ids into this rank's e_loc experts, clamped;
    the mask of the slots whose expert is this rank's)."""
    local = eidx - my_model_rank * e_loc
    mine = (local >= 0) & (local < e_loc)
    return local.clamp(0, e_loc - 1), mine


def moe_local(x_local, router, wi, wg, wo, my_model_rank: int, n_model: int,
              cfg: ModelConfig, share=None):
    """One rank's share of the shard_map branch, with no collective: its
    tl tokens x_local (tl, d) routed by the whole router (d, E), the slots
    of its e_loc = E / n_model experts wi / wg (e_loc, d, f), wo (e_loc,
    f, d) dispatched with positions and capacity counted over its tokens
    and its experts only (capacity from tl).  Returns (the partial (tl,
    d) in x's dtype, zero where no slot of a token is this rank's; the
    shard's Switch aux loss, float32).  `share` (the wrapper's
    `replicated_input`) marks the tokens and gates the rank's experts
    read."""
    tl = x_local.shape[0]
    e, k = cfg.n_experts, cfg.experts_per_token
    e_loc = wi.shape[0]
    if e_loc * n_model != e:
        raise ValueError(f"a rank of {n_model} over `model` holds {e // n_model} of "
                         f"{e} experts; these weights hold {e_loc}")
    logits, gate, eidx = route(router, x_local, cfg)
    safe, mine = _local_experts(eidx, my_model_rank, e_loc)
    capl = capacity(tl, cfg)
    pos = slot_positions(safe.reshape(-1), e_loc, mine.reshape(-1)).reshape(tl, k)
    keep = mine & (pos >= 0) & (pos < capl)
    if share is not None:
        x_local, gate = share(x_local), share(gate)
    out = _expert_sum(x_local, safe, pos, keep, gate, wi, wg, wo, capl)
    return out, _aux_loss(logits, eidx, e)


def moe_share(x_local, gate, eidx, ids, me: int, wi, wg, wo, e_rank: int, cfg: ModelConfig,
              share=None):
    """One rank's share of the dispatch over the global token order (the
    mesh form's every call but the shard_map branch), with no collective.
    ids (n_batch, tl, k): the expert ids of every batch rank's tl tokens
    in rank order (the global token order), the rank's own at `me` (its
    tokens x_local (tl, d), gates and ids eidx (tl, k)); wi / wg / wo the
    rank's experts e_rank * E_rank .. (expert parallel) or all E with the
    rank's block of each FFN (e_rank 0).  The tokens run in moe_dp blocks
    where moe_dp > 1 divides them, else one; capacity and positions are
    counted a block, so the same slots drop as in the unmeshed layer.

    The rank's kept slots to expert e in a block are one run of positions:
    after the block's earlier tokens' slots to e (counted from `ids`),
    in its own tokens' order.  Its buffer holds those runs only: cap rows
    for a block whose every token is the rank's (the unmeshed layer's
    buffer), min(its tokens there, cap) for part of one (a token's k
    experts are distinct, so it adds at most one slot to e).  Returns the
    partial (tl, d), zero where no slot of a token is the rank's.  `share`
    (the wrapper's `replicated_input`) marks the tokens and gates the
    rank's experts read."""
    n_batch, tl, k = ids.shape
    e, e_loc = cfg.n_experts, wi.shape[0]
    t = n_batch * tl
    blocks = cfg.moe_dp if cfg.moe_dp > 1 and t % cfg.moe_dp == 0 else 1
    bs = t // blocks
    cap = capacity(bs, cfg)
    safe, mine = _local_experts(eidx, e_rank, e_loc)
    flat = ids.reshape(t * k)
    first = me * tl
    rows = torch.zeros_like(safe)
    keep = torch.zeros_like(mine)
    base = 0
    for blk in range(first // bs, (first + tl - 1) // bs + 1):
        a, z = max(blk * bs, first), min((blk + 1) * bs, first + tl)
        earlier = flat[blk * bs * k:a * k]
        off = torch.zeros(e, dtype=torch.int64, device=ids.device).scatter_add_(
            0, earlier, torch.ones_like(earlier))[e_rank * e_loc:(e_rank + 1) * e_loc]
        sl = slice(a - first, z - first)
        local = slot_positions(safe[sl].reshape(-1), e_loc,
                               mine[sl].reshape(-1)).reshape(z - a, k)
        keep[sl] = mine[sl] & (off[safe[sl]] + local < cap)
        rows[sl] = base + local
        base += cap if z - a == bs else min(z - a, cap)
    if share is not None:
        x_local, gate = share(x_local), share(gate)
    return _expert_sum(x_local, safe, rows, keep, gate, wi, wg, wo, base)


def _batch_exchange_axes(mesh, batch_axes) -> list:
    """The axes of `batch_axes` the batch's reductions run over, one counted
    call each: those with more than one rank (both of ("pod", "data")
    across pods), else the last."""
    from repro_torch.core.distributed import _real_axes

    return _real_axes(mesh, batch_axes) or [batch_axes[-1]]


def _moe_expert_parallel(p: MoE, xf: torch.Tensor, cfg: ModelConfig, ctx):
    """The mesh form (see the module's docstring), with gradients.  xf
    (t_local, d) -> ((t_local, d), aux)."""
    from repro_torch.core.distributed import (_axis_rank, _axis_size, all_gather_axes,
                                              reduce_partials, replicated_input)

    mesh = ctx.mesh
    e = cfg.n_experts
    n_model = _axis_size(mesh, "model")
    my = _axis_rank(mesh, "model")
    b_axes = _batch_exchange_axes(mesh, ctx.batch_axes)
    # a whole batch (every rank holds all of it) is routed as the unmeshed
    # layer routes it: no exchange over the batch axes
    n_batch = 1 if ctx.batch_whole else _axis_size(mesh, ctx.batch_axes)

    def over_batch(t, site):
        for a in b_axes:
            t = reduce_partials(t, mesh, a, site)
        return t

    w = SimpleNamespace(**{n: tp.whole_over_data(getattr(p, n), "moe_weights")
                           for n in ("router", "wi", "wg", "wo")})
    expert_parallel = 0 in tp.dims_over(tp.spec_of(p.wi), "model")
    # expert parallelism: the rank's experts; TP inside experts (or experts
    # whole on every rank): all E, the rank's block of each expert's FFN
    e_rank, e_ranks = (my, n_model) if expert_parallel else (0, 1)
    if w.wi.shape[0] * e_ranks != e:
        raise ValueError(f"this MoE layer holds {w.wi.shape[0]} experts; a rank of a "
                         f"{n_model}-rank `model` axis holds {e // e_ranks} "
                         f"(convert.moe_block)")

    def share(t):
        return replicated_input(t, mesh, "model", "moe_in")

    tl = xf.shape[0]
    t = tl * n_batch
    blocks = cfg.moe_dp if cfg.moe_dp > 1 and t % cfg.moe_dp == 0 else 1
    if expert_parallel and blocks > 1 and not ctx.batch_whole:
        out, aux = moe_local(xf, w.router, w.wi, w.wg, w.wo, my, n_model, cfg, share)
        aux = over_batch(aux.reshape(1), "moe_aux")[0] / n_batch
    else:
        logits, gate, eidx = route(w.router, xf, cfg)
        ids = (all_gather_axes(eidx, mesh, ctx.batch_axes, "moe_ids") if n_batch > 1
               else eidx[None])                               # (n_batch, tl, k)
        me = _axis_rank(mesh, ctx.batch_axes) if n_batch > 1 else 0
        out = moe_share(xf, gate, eidx, ids, me, w.wi, w.wg, w.wo, e_rank, cfg, share)
        f = nn.functional.one_hot(eidx[:, 0], e).float().mean(0)
        fp = torch.stack([f, torch.softmax(logits, dim=-1).mean(0)])
        if not ctx.batch_whole:
            fp = over_batch(fp, "moe_aux") / n_batch
        aux = e * torch.sum(fp[0] * fp[1])
    out = reduce_partials(out, mesh, "model", "moe_combine")
    if cfg.n_shared_experts:
        out = out + L.mlp(p.shared, xf)
    return out, aux


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) -> (out (B, S, d), aux_loss float32 scalar).  Under a
    mesh context x is this rank's data shard of the batch."""
    b, s, d = x.shape
    t = b * s
    e = cfg.n_experts
    xf = x.reshape(t, d)
    ctx = mesh_ctx.current()
    if ctx is not None:
        out, aux = _moe_expert_parallel(p, xf, cfg, ctx)
        return out.reshape(b, s, d), aux
    if cfg.moe_dp > 1 and t % cfg.moe_dp == 0:
        out, aux = _moe_two_stage(p, xf, cfg)
        return out.reshape(b, s, d), aux

    logits, gate, eidx = route(p, xf, cfg)                    # (T, E), (T, k)
    cap = capacity(t, cfg)
    pos = slot_positions(eidx.reshape(-1), e).reshape(eidx.shape)
    out = _expert_sum(xf, eidx, pos, pos < cap, gate, p.wi, p.wg, p.wo, cap)
    if cfg.n_shared_experts:
        out = out + L.mlp(p.shared, xf)
    return out.reshape(b, s, d), _aux_loss(logits, eidx, e)
