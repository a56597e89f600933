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
context, the expert-parallel form.  There a rank holds its data shard of
the tokens (replicated over `model`) and its E / n_model experts
(`convert.lm_params_block`; under cfg.fsdp also its `data` slice of d in
router, wi, wg and wo, all-gathered before use).  `moe_local` is one
rank's share with no collective; `moe_ffn` wraps it with the counted
collectives of `core/distributed.py`:
  - the shard_map branch (moe_dp > 1 divides the GLOBAL token count):
    capacity and positions per (data shard, local expert), the aux the
    per-shard Switch loss averaged over the batch axes (one all-reduce);
  - the single-stage branch (every other call, e.g. decode's B tokens):
    the single-stage capacity and positions over the global token order,
    data rank first (one all-gather of the (t_local, k) expert ids over
    the batch axis when it has more than one rank), the aux the
    single-stage formula over all tokens (one all-reduce of the shards'
    first-choice fractions and mean probabilities);
  - both: the (t_local, d) partials all-reduced over `model` in the
    model's dtype, the shared experts added after the sum.
E % model != 0 (the reference's TP inside each expert) raises: ROADMAP
A12b.  At data 1 the expert-parallel form equals the single-stage
`moe_ffn` bit for bit at top-2: the same capacity and slot order, and at
most two nonzero partials a token.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import ctx as mesh_ctx


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
              cfg: ModelConfig):
    """One rank's share of the shard_map branch, with no collective: its
    tl tokens x_local (tl, d) routed by the whole router (d, E), the slots
    of its e_loc = E / n_model experts wi / wg (e_loc, d, f), wo (e_loc,
    f, d) dispatched with positions and capacity counted over its tokens
    and its experts only (capacity from tl).  Returns (the partial (tl,
    d) in x's dtype, zero where no slot of a token is this rank's; the
    shard's Switch aux loss, float32)."""
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
    out = _expert_sum(x_local, safe, pos, keep, gate, wi, wg, wo, capl)
    return out, _aux_loss(logits, eidx, e)


def _batch_axis(mesh, batch_axes) -> str:
    """The axis of `batch_axes` the batch's exchanges run over: the one
    with more than one rank, else the last."""
    from repro_torch.core.distributed import _axis_size

    real = [a for a in batch_axes if _axis_size(mesh, a) > 1]
    if len(real) > 1:
        raise NotImplementedError(f"the expert-parallel MoE exchanges over one batch axis; "
                                  f"{batch_axes} has {len(real)} of more than one rank")
    return real[0] if real else batch_axes[-1]


def _gather_dim(t: torch.Tensor, mesh, axis: int) -> torch.Tensor:
    """The whole tensor from each `data` rank's slice of dim `axis` (one
    counted all-gather)."""
    from repro_torch.core.distributed import all_gather

    g = all_gather(t, mesh, "data", "moe_weights")            # (n, *t.shape)
    return g[0] if g.shape[0] == 1 else torch.cat(list(g.unbind(0)), dim=axis)


def _moe_expert_parallel(p: MoE, xf: torch.Tensor, cfg: ModelConfig, ctx):
    """The mesh wrapper of `moe_local` (see the module's docstring), for
    serving (no autograd).  xf (t_local, d) -> ((t_local, d), aux)."""
    from repro_torch.core.distributed import _axis_rank, _axis_size, all_gather, all_reduce

    mesh = ctx.mesh
    if torch.is_grad_enabled() and p.router.requires_grad:
        raise NotImplementedError("the expert-parallel MoE serves: its collectives carry no "
                                  "gradients (training under a mesh is ROADMAP A12b)")
    e = cfg.n_experts
    n_model = _axis_size(mesh, "model")
    if e % n_model:
        raise NotImplementedError(
            f"{e} experts over a {n_model}-rank `model` axis: tensor parallelism inside "
            f"each expert is not ported yet (ROADMAP A12b)")
    my = _axis_rank(mesh, "model")
    b_ax = _batch_axis(mesh, ctx.batch_axes)
    n_batch = _axis_size(mesh, ctx.batch_axes)
    router, wi, wg, wo = p.router, p.wi, p.wg, p.wo
    if wi.shape[0] * n_model != e:
        raise ValueError(f"this MoE layer holds {wi.shape[0]} experts; a rank of a "
                         f"{n_model}-rank `model` axis holds {e // n_model} "
                         f"(convert.lm_params_block)")
    if cfg.fsdp:
        n_data = _axis_size(mesh, "data")
        if router.shape[0] * n_data != cfg.d_model:
            raise ValueError(f"under fsdp a rank holds d_model / {n_data} rows of the "
                             f"router; this one holds {router.shape[0]} of "
                             f"{cfg.d_model} (convert.lm_params_block)")
        router = _gather_dim(router, mesh, 0)
        wi, wg, wo = _gather_dim(wi, mesh, 1), _gather_dim(wg, mesh, 1), \
            _gather_dim(wo, mesh, 2)
    k, tl = cfg.experts_per_token, xf.shape[0]
    t = tl * n_batch
    if cfg.moe_dp > 1 and t % cfg.moe_dp == 0:
        out, aux = moe_local(xf, router, wi, wg, wo, my, n_model, cfg)
        aux = all_reduce(aux.reshape(1), mesh, b_ax, "moe_aux")[0] / n_batch
    else:
        logits, gate, eidx = route(router, xf, cfg)
        cap = capacity(t, cfg)
        ids = (all_gather(eidx, mesh, b_ax, "moe_ids") if n_batch > 1
               else eidx[None])                               # (n_batch, tl, k)
        pos = slot_positions(ids.reshape(-1), e).reshape(n_batch, tl, k)
        pos = pos[_axis_rank(mesh, b_ax) if n_batch > 1 else 0]
        safe, mine = _local_experts(eidx, my, wi.shape[0])
        out = _expert_sum(xf, safe, pos, mine & (pos < cap), gate, wi, wg, wo, cap)
        f = nn.functional.one_hot(eidx[:, 0], e).float().mean(0)
        fp = all_reduce(torch.stack([f, torch.softmax(logits, dim=-1).mean(0)]), mesh,
                        b_ax, "moe_aux") / n_batch
        aux = e * torch.sum(fp[0] * fp[1])
    out = all_reduce(out, mesh, "model", "moe_combine")
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
