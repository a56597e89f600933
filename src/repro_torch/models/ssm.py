"""Mamba2 mixer (port of `repro.models.ssm`; SSD, state-space duality,
arXiv:2405.21060), in plain PyTorch: the reference has no Pallas kernel
here.

The chunked SSD algorithm, as the reference's "minimal" formulation:
  1. intra-chunk outputs (quadratic within a chunk of Q tokens),
  2. each chunk's final state,
  3. the inter-chunk recurrence on the chunk states (a loop over chunks
     in float32, the reference's `lax.scan`),
  4. the state -> output correction.

Prefill runs the chunked scan, decode the O(1) recurrent update on the
(conv, ssm) cache, written in place.  The mixer runs in four stages
(`ssm_conv`, `ssm_heads`, `ssm_out` after the in_proj product), so that
under a mesh context a rank runs the SSD over its own heads, with the
collectives between the stages (`mamba_mixer`).  Head layout as the reference: x
(B, L, H, P), one scalar A a head, B / C shared across heads
(ngroups = 1).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import ctx as mesh_ctx
from repro_torch.sharding import tp


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., q) -> (..., q, q): S[i, j] = sum_{k=j+1..i} x[k], -inf above
    the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(q, device=x.device)
    return diff.masked_fill(~(i[:, None] >= i[None, :]), float("-inf"))


def ssd_chunked(x, a, b, c, chunk: int):
    """SSD scan.

    x (B, L, H, P) inputs (already multiplied by dt); a (B, L, H) the
    per-step log-decay (dt * A, negative); b, c (B, L, N) the input and
    output projections.  Returns y (B, L, H, P) in x's dtype and the
    final state (B, H, P, N) float32."""
    bs, l, h, p = x.shape
    n = b.shape[-1]
    if l % chunk:
        raise ValueError(f"ssd_chunked: L = {l} is not a multiple of chunk {chunk}")
    nc = l // chunk
    xc = x.reshape(bs, nc, chunk, h, p).float()
    ac = a.reshape(bs, nc, chunk, h).permute(0, 3, 1, 2)   # (B, H, C, Q)
    bc = b.reshape(bs, nc, chunk, n)
    cc = c.reshape(bs, nc, chunk, n)
    # a per-row cumsum of the 4-d tensor (a fixed order on the card too)
    a_cumsum = torch.cumsum(ac, dim=-1)                    # (B, H, C, Q)

    # 1. intra-chunk
    el = torch.exp(_segsum(ac))                            # (B, H, C, Q, Q)
    scores = torch.einsum("bcqn,bcsn->bcqs", cc, bc)       # (B, C, Q, Q)
    y_diag = torch.einsum("bhcqs,bcshp->bcqhp", scores.float()[:, None] * el, xc)
    del el

    # 2. chunk final states
    decay_states = torch.exp(a_cumsum[..., -1:] - a_cumsum)               # (B, H, C, Q)
    states = torch.einsum("bcsn,bcshp->bchpn", bc.float(),
                          xc * decay_states.permute(0, 2, 3, 1)[..., None])  # (B, C, H, P, N)

    # 3. inter-chunk recurrence: the state before each chunk
    chunk_decay = torch.exp(a_cumsum[..., -1])             # (B, H, C)
    prev = torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
    prev_states = []
    for ci in range(nc):
        prev_states.append(prev)
        prev = prev * chunk_decay[:, :, ci, None, None] + states[:, ci]
    prev_states = torch.stack(prev_states, dim=1)          # (B, C, H, P, N)

    # 4. state -> output
    state_decay = torch.exp(a_cumsum).permute(0, 2, 3, 1)  # (B, C, Q, H)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", cc.float(), prev_states) * state_decay[..., None]
    y = (y_diag + y_off).reshape(bs, l, h, p)
    return y.to(x.dtype), prev


class Mamba(nn.Module):
    """in_proj (d, 2 d_inner + 2 N + H), conv_w (d_conv, CH), conv_b (CH,),
    a_log, dt_bias, d_skip (H,) float32, norm_w (d_inner,), out_proj
    (d_inner, d); CH = d_inner + 2 N."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        dt = L.dtype_of(cfg)
        d, di, ns, nh = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.ssm_heads
        conv_ch = di + 2 * ns
        self.in_proj = nn.Parameter(L.dense_init(generator, d, 2 * di + 2 * ns + nh, dt,
                                                 device))
        conv_w = L.randn(generator, (cfg.d_conv, conv_ch)) * 0.1
        self.conv_w = nn.Parameter(conv_w.to(device=device, dtype=dt))
        self.conv_b = nn.Parameter(torch.zeros(conv_ch, dtype=dt, device=device))
        self.a_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, nh, device=device)))
        self.dt_bias = nn.Parameter(torch.zeros(nh, device=device))
        self.d_skip = nn.Parameter(torch.ones(nh, device=device))
        self.norm_w = nn.Parameter(torch.ones(di, dtype=dt, device=device))
        self.out_proj = nn.Parameter(L.dense_init(generator, di, d, dt, device))


def init_mamba(generator: torch.Generator, cfg: ModelConfig, device) -> Mamba:
    return Mamba(cfg, generator, device)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """conv (batch, K-1, CH) and ssm (batch, H, P, N) float32, CH = d_inner
    + 2 N (a rank of a mesh holds its blocks: `models.model.init_cache`)."""
    return {"conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner + 2 * cfg.d_state),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.d_state),
                               dtype=torch.float32, device=device)}


def _causal_conv(xbc, w, b, conv_state=None):
    """Depthwise causal conv1d.  xbc (B, L, CH); w (K, CH); conv_state
    (B, K-1, CH) the history in incremental mode (None: zeros).  Returns
    (out, new history)."""
    k = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                     # (B, L+K-1, CH)
    lx = xbc.shape[1]
    out = xp[:, 0:lx] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + lx] * w[i]
    return out + b, xp[:, -(k - 1):]


def ssm_conv(p, proj: torch.Tensor, cfg: ModelConfig, rank: int = 0,
             cache: dict | None = None) -> torch.Tensor:
    """silu(depthwise causal conv) of the [x | B | C] channels of the whole
    in_proj output `proj`: the rank's channel block where conv_w / conv_b
    are one (the conv is channel-local, so a block is exact), with its
    block of the conv history, updated in place."""
    di = cfg.d_inner
    w = p.conv_w.shape[1]
    lo = di + rank * w if w != di + 2 * cfg.d_state else di
    out, new_conv = _causal_conv(proj[..., lo:lo + w], p.conv_w, p.conv_b,
                                 None if cache is None else cache["conv"])
    if cache is not None:
        cache["conv"].copy_(new_conv)
    return nn.functional.silu(out)


def _rows(p, cfg: ModelConfig, rank: int):
    """(first row of d_inner, rows, first head, end head) of the rank's rows
    of out_proj and the heads they cover (all of them where it is whole)."""
    di, hp = cfg.d_inner, cfg.ssm_head_dim
    rows = p.out_proj.shape[0]
    c0 = rank * rows if rows != di else 0
    return c0, rows, c0 // hp, -(-(c0 + rows) // hp)


def ssm_heads(p, proj: torch.Tensor, conv: torch.Tensor, cfg: ModelConfig, rank: int = 0,
              cache: dict | None = None):
    """The SSD of the heads the rank's rows of out_proj cover (whole heads,
    all of them where out_proj is whole), from the whole in_proj output
    (its z and dt) and the whole conv output (x, and B / C, which every
    head shares): the chunked scan for a prefill or training (L > 1 or
    no cache), the recurrence for a decode step.  Returns (g, ssq): the
    gated output y * silu(z) at the rank's rows and its sum of squares
    over them (B, L, 1) float32.  a_log / dt_bias / d_skip and the ssm
    state are the rank's heads' blocks, or whole (sliced here)."""
    bs, l, _ = proj.shape
    di, ns, nh, hp = cfg.d_inner, cfg.d_state, cfg.ssm_heads, cfg.ssm_head_dim
    c0, rows, h_lo, h_hi = _rows(p, cfg, rank)
    nr = h_hi - h_lo

    def heads(t):
        return t[h_lo:h_hi] if t.shape[0] == nh else t

    dt = nn.functional.softplus(proj[..., 2 * di + 2 * ns + h_lo:2 * di + 2 * ns + h_hi].float()
                                + heads(p.dt_bias))                # (B, L, nr)
    a = -torch.exp(heads(p.a_log))                                 # (nr,)
    xh = conv[..., h_lo * hp:h_hi * hp].reshape(bs, l, nr, hp)
    b_, c_ = conv[..., di:di + ns], conv[..., di + ns:]
    st0 = None
    if cache is not None:
        st0 = cache["ssm"][:, h_lo:h_hi] if cache["ssm"].shape[1] == nh else cache["ssm"]

    if cache is None or l > 1:
        # chunked scan (prefill); L padded to a chunk multiple, dt = 0 there
        chunk = min(cfg.ssd_chunk, l) if l % cfg.ssd_chunk else cfg.ssd_chunk
        pad = (-l) % chunk
        xh_p, dt_p, b_p, c_p = xh, dt, b_, c_
        if pad:
            xh_p = nn.functional.pad(xh, (0, 0, 0, 0, 0, pad))
            dt_p = nn.functional.pad(dt, (0, 0, 0, pad))
            b_p = nn.functional.pad(b_, (0, 0, 0, pad))
            c_p = nn.functional.pad(c_, (0, 0, 0, pad))
        y, final = ssd_chunked(xh_p * dt_p[..., None].to(xh.dtype), dt_p * a, b_p, c_p, chunk)
        y = y[:, :l]
        if cache is not None:
            st0.copy_(final)
    else:
        # O(1) decode: state' = state exp(dt a) + dt (b ⊗ x); y = c . state'
        dt1 = dt[:, 0]                                     # (B, nr)
        decay = torch.exp(dt1 * a)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt1, b_[:, 0].float(), xh[:, 0].float())
        st = st0 * decay[..., None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", c_[:, 0].float(), st)[:, None].to(proj.dtype)
        st0.copy_(st)

    y = y + (heads(p.d_skip)[None, None, :, None] * xh.float()).to(y.dtype)
    y = y.reshape(bs, l, nr * hp)[..., c0 - h_lo * hp:c0 - h_lo * hp + rows]
    g = y * nn.functional.silu(proj[..., c0:c0 + rows])
    gf = g.float()
    return g, torch.sum(gf * gf, dim=-1, keepdim=True)


def ssm_out(p, g: torch.Tensor, ssq: torch.Tensor, cfg: ModelConfig, rank: int = 0):
    """The gated RMS norm over d_inner from the sum of squares of every row
    (`ssq`, summed over the ranks' rows), then the rank's rows of out_proj:
    its partial (B, L, d_model) (the whole output where out_proj is
    whole).  norm_w is the rank's rows, or whole (sliced here)."""
    c0, rows, _, _ = _rows(p, cfg, rank)
    w = p.norm_w if p.norm_w.shape[0] == rows else p.norm_w[c0:c0 + rows]
    y = g.float() * torch.rsqrt(ssq / cfg.d_inner + cfg.norm_eps)
    return (y * w.float()).to(g.dtype) @ p.out_proj


def mamba_mixer(p: Mamba, x: torch.Tensor, cfg: ModelConfig,
                cache: dict | None = None) -> torch.Tensor:
    """x (B, L, d_model) -> (B, L, d_model).  cache: None or {"conv": (B,
    K-1, CH), "ssm": (B, H, P, N)}, updated in place: the chunked scan's
    final state after a prefill (L > 1), one recurrent step at L = 1.

    Four stages: the in_proj product, the conv (`ssm_conv`), the SSD of
    the rank's heads (`ssm_heads`) and the gated norm with out_proj's
    rows (`ssm_out`).  Under a mesh context the weights are the rank's
    blocks (`sharding.tp`), gathered over `data` under fsdp, and between
    the stages: in_proj's column block (its [z | x | B | C | dt] columns
    straddle the segments) gathered over `model` ("ssm_in"); the conv on
    the rank's channel block, gathered ("ssm_conv"); the SSD over the
    rank's heads only; the norm's sum of squares all-reduced ("ssm_norm");
    the partial reduced ("ssm_out").  The cache holds the rank's conv
    channels and ssm heads (all of them where they do not split).

    Gradients: a replicated tensor is marked by `replicated_input` (site
    "ssm_mark") where work of the rank's own reads it: x before in_proj's
    column block, the in_proj output before the conv's channel block and
    before the rank's heads, a whole conv output, and a whole a_log /
    dt_bias / d_skip where the rank computes a subset of the heads; a
    gather whose readers are the rank's own work sums their gradients
    (`gather_shards`), any other keeps the rank's block of a whole one
    (`gather_replicated`); the norm's sum of squares is a sum of
    partials whose gradient every rank's rows share (an all-reduce both
    ways).  So a replicated parameter's gradient is whole on every rank,
    counted once."""
    if mesh_ctx.current() is None:
        proj = x @ p.in_proj
        conv = ssm_conv(p, proj, cfg, cache=cache)
        g, ssq = ssm_heads(p, proj, conv, cfg, cache=cache)
        return ssm_out(p, g, ssq, cfg)
    w = tp.gathered(p)
    split = {n: tp.over_model(sp) for n, sp in w.specs.items()}
    r = tp.rank(tp.MODEL)
    mark = lambda t: tp.replicated_input(t, "ssm_mark")  # noqa: E731
    own = split["out_proj"]           # the heads' work is the rank's own
    conv_own = split["conv_w"]        # the conv is the rank's channel block

    def gather(t, site, readers_own):
        return (tp.gather_model(t, -1, site) if readers_own
                else tp.gather_model_replicated(t, -1, site))

    # the in_proj output, whole; then what reads it: the conv and the heads
    both_own = own and conv_own
    if split["in_proj"]:
        proj = gather(mark(x) @ w.in_proj, "ssm_in", both_own)
    else:
        proj = x @ w.in_proj
        if both_own:
            proj = mark(proj)
    into_conv = mark(proj) if conv_own and not both_own else proj
    into_heads = mark(proj) if own and not both_own else proj
    conv = ssm_conv(w, into_conv, cfg, r, cache)
    if conv_own:
        conv = gather(conv, "ssm_conv", own)
    elif own:
        conv = mark(conv)
    if own:
        for n in ("a_log", "dt_bias", "d_skip"):
            if not split[n]:
                setattr(w, n, mark(getattr(w, n)))
    g, ssq = ssm_heads(w, into_heads, conv, cfg, r, cache)
    if own:
        ssq = mark(tp.reduce_model(ssq, "ssm_norm"))
    out = ssm_out(w, g, ssq, cfg, r)
    return tp.reduce_model(out, "ssm_out") if own else out
