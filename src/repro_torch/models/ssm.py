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
(conv, ssm) cache, written in place.  Head layout as the reference: x
(B, L, H, P), one scalar A a head, B / C shared across heads
(ngroups = 1).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


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
    conv_ch = cfg.d_inner + 2 * cfg.d_state
    return {"conv": torch.zeros((batch, cfg.d_conv - 1, conv_ch), dtype=dtype, device=device),
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


def mamba_mixer(p: Mamba, x: torch.Tensor, cfg: ModelConfig,
                cache: dict | None = None) -> torch.Tensor:
    """x (B, L, d_model) -> (B, L, d_model).  cache: None or {"conv": (B,
    K-1, CH), "ssm": (B, H, P, N)}, updated in place: the chunked scan's
    final state after a prefill (L > 1), one recurrent step at L = 1."""
    bs, l, _ = x.shape
    di, ns, nh, hp = cfg.d_inner, cfg.d_state, cfg.ssm_heads, cfg.ssm_head_dim

    proj = x @ p.in_proj
    z, xin, b_, c_, dt = torch.split(proj, [di, di, ns, ns, nh], dim=-1)
    xbc = torch.cat([xin, b_, c_], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p.conv_w, p.conv_b,
                                 None if cache is None else cache["conv"])
    xbc = nn.functional.silu(xbc)
    xin, b_, c_ = torch.split(xbc, [di, ns, ns], dim=-1)

    dt = nn.functional.softplus(dt.float() + p.dt_bias)    # (B, L, H)
    a = -torch.exp(p.a_log)                                # (H,)
    xh = xin.reshape(bs, l, nh, hp)

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
            cache["conv"].copy_(new_conv)
            cache["ssm"].copy_(final)
    else:
        # O(1) decode: state' = state exp(dt a) + dt (b ⊗ x); y = c . state'
        dt1 = dt[:, 0]                                     # (B, H)
        decay = torch.exp(dt1 * a)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt1, b_[:, 0].float(), xh[:, 0].float())
        st = cache["ssm"] * decay[..., None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", c_[:, 0].float(), st)[:, None].to(x.dtype)
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(st)

    y = y + (p.d_skip[None, None, :, None] * xh.float()).to(y.dtype)
    y = y.reshape(bs, l, di)
    y = L.rms_norm(y * nn.functional.silu(z), p.norm_w, cfg.norm_eps)
    return y @ p.out_proj
