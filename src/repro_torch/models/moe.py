"""Mixture-of-Experts layer (port of `repro.models.moe`): top-k routing and
the capacity-bounded scatter dispatch into an (E, C, d) expert buffer.

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
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


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


def route(p: MoE, xf: torch.Tensor, cfg: ModelConfig):
    """(..., T, d) tokens -> (router logits (..., T, E) float32, gates
    (..., T, k) float32 normalised to sum 1, expert ids (..., T, k))."""
    logits = xf.float() @ p.router
    if cfg.attn_type == "mla":  # deepseek-style sigmoid scoring
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    k = cfg.experts_per_token
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    gate, eidx = vals[..., :k], idx[..., :k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return logits, gate, eidx


def slot_positions(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Position of each flat (token, slot) pair in its expert's buffer: the
    count of earlier pairs routed to the same expert (cumsum over the
    flat slots, token-major).  flat_e (..., T*k) -> (..., T*k) int64."""
    onehot = nn.functional.one_hot(flat_e, e)
    return (torch.cumsum(onehot, dim=-2) * onehot).sum(-1) - 1


def expert_ffn(p: MoE, buf: torch.Tensor) -> torch.Tensor:
    """SwiGLU of each expert on its buffer: (..., E, C, d) -> (..., E, C, d)."""
    hidden = nn.functional.silu(torch.matmul(buf, p.wg)) * torch.matmul(buf, p.wi)
    return torch.matmul(hidden, p.wo)


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


def _moe_two_stage(p: MoE, xf: torch.Tensor, cfg: ModelConfig):
    """The reference's per-data-shard dispatch (cfg.moe_dp blocks of
    tokens, positions and capacity counted within each block), taken when
    moe_dp > 1 and no mesh is active: the port's MoE takes no mesh, so
    this is its moe_dp > 1 path.  xf (T, d) -> ((T, d), aux)."""
    t, d = xf.shape
    dp = cfg.moe_dp
    e, k = cfg.n_experts, cfg.experts_per_token
    tl = t // dp
    xb = xf.reshape(dp, tl, d)
    logits, gate, eidx = route(p, xb, cfg)                    # (dp, tl, ·)
    capl = capacity(tl, cfg)
    flat_e = eidx.reshape(dp, tl * k)
    pos = slot_positions(flat_e, e)
    keep = pos < capl
    pos_c = pos.clamp(0, capl - 1)
    tok = torch.arange(tl, device=xf.device).repeat_interleave(k)
    buf = torch.zeros((dp, e, capl, d), dtype=xf.dtype, device=xf.device)
    blk = torch.arange(dp, device=xf.device)[:, None].expand(dp, tl * k)
    vals = torch.where(keep[..., None], xb[:, tok], torch.zeros((), dtype=xf.dtype,
                                                                device=xf.device))
    # a kept slot's (expert, position) is its own; a dropped one adds 0
    buf.index_put_((blk, flat_e, pos_c), vals, accumulate=True)
    out_buf = expert_ffn(p, buf)                              # (dp, E, C, d)
    out = torch.stack([
        _combine(out_buf[i], flat_e[i].reshape(tl, k), pos_c[i].reshape(tl, k),
                 keep[i].reshape(tl, k), gate[i], xf.dtype) for i in range(dp)])
    out = out.reshape(t, d)
    if cfg.n_shared_experts:
        out = out + L.mlp(p.shared, xf)
    return out, _aux_loss(logits.reshape(t, e), eidx.reshape(t, k), e)


def _moe_shard_map(p: MoE, xf: torch.Tensor, cfg: ModelConfig):
    """The reference's expert-parallel form over a mesh: not ported."""
    raise NotImplementedError("the sharded MoE (shard_map over a mesh) is not "
                              "ported yet (ROADMAP A11b)")


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) -> (out (B, S, d), aux_loss float32 scalar)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.experts_per_token
    xf = x.reshape(t, d)
    if cfg.moe_dp > 1 and t % cfg.moe_dp == 0:
        out, aux = _moe_two_stage(p, xf, cfg)
        return out.reshape(b, s, d), aux

    logits, gate, eidx = route(p, xf, cfg)                    # (T, E), (T, k)
    cap = capacity(t, cfg)
    flat_e = eidx.reshape(-1)                                 # (T*k,)
    pos = slot_positions(flat_e, e)
    keep = pos < cap
    pos_c = pos.clamp(0, cap - 1)
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    vals = torch.where(keep[:, None], xf[tok], torch.zeros((), dtype=x.dtype,
                                                           device=x.device))
    # a kept slot's (expert, position) is its own; a dropped one adds 0
    buf.index_put_((flat_e, pos_c), vals, accumulate=True)
    out_buf = expert_ffn(p, buf)                              # (E, C, d)
    out = _combine(out_buf, eidx, pos_c.reshape(t, k), keep.reshape(t, k), gate, x.dtype)
    if cfg.n_shared_experts:
        out = out + L.mlp(p.shared, xf)
    return out.reshape(b, s, d), _aux_loss(logits, eidx, e)
