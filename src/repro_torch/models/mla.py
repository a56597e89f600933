"""Multi-head Latent Attention (port of `repro.models.mla`; DeepSeek-V2/V3,
arXiv:2412.19437).

Queries and keys / values come through low-rank bottlenecks; the cache
holds only the compressed latent (kv_lora_rank) and one shared RoPE key
(qk_rope_dim) a token.

Two decode paths, as in the reference:
  * materialized: K / V expanded from the latent every step (in float32
    on a decode step, in the cache's dtype at prefill), then
    `layers.attention_core`, which takes the flash kernel at
    Dqk = nope + rope, Dv = v_head_dim once the keys reach
    cfg.flash_threshold;
  * absorbed (cfg.mla_absorbed_decode): W_uk folded into the query and
    W_uv into the output, attention in latent space, contracted in
    float32.

The cache is written in place, as the port's GQA cache.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


class MLA(nn.Module):
    """wkv_a (d, kv_rank + rope), kv_norm, wk_b (kv_rank, H nope), wv_b
    (kv_rank, H v), wo (H v, d); with a q bottleneck wq_a (d, q_rank),
    q_norm, wq_b (q_rank, H (nope + rope)), else wq (d, H (nope + rope))."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        dt = L.dtype_of(cfg)
        d, h = cfg.d_model, cfg.n_heads
        qr = cfg.q_lora_rank or d
        kr = cfg.kv_lora_rank
        nope, rope_d, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        if cfg.q_lora_rank:
            self.wq_a = nn.Parameter(L.dense_init(generator, d, qr, dt, device))
            self.q_norm = nn.Parameter(torch.ones(qr, dtype=dt, device=device))
            self.wq_b = nn.Parameter(L.dense_init(generator, qr, h * (nope + rope_d), dt,
                                                  device))
        else:
            self.wq = nn.Parameter(L.dense_init(generator, d, h * (nope + rope_d), dt, device))
        self.wkv_a = nn.Parameter(L.dense_init(generator, d, kr + rope_d, dt, device))
        self.kv_norm = nn.Parameter(torch.ones(kr, dtype=dt, device=device))
        self.wk_b = nn.Parameter(L.dense_init(generator, kr, h * nope, dt, device))
        self.wv_b = nn.Parameter(L.dense_init(generator, kr, h * vdim, dt, device))
        self.wo = nn.Parameter(L.dense_init(generator, h * vdim, d, dt, device))


def init_mla(generator: torch.Generator, cfg: ModelConfig, device) -> MLA:
    return MLA(cfg, generator, device)


def init_mla_cache(cfg: ModelConfig, batch: int, s_max: int, dtype, device) -> dict:
    return {"ckv": torch.zeros((batch, s_max, cfg.kv_lora_rank), dtype=dtype, device=device),
            "krope": torch.zeros((batch, s_max, cfg.qk_rope_dim), dtype=dtype, device=device)}


def mla_attention(p: MLA, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                  cache: dict | None = None, cache_len: int = 0) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d).  cache: None, or {"ckv": (B, S_max,
    kv_rank), "krope": (B, S_max, rope)}, written in place at
    [cache_len, cache_len + S)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope_d, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank

    if cfg.q_lora_rank:
        q = L.rms_norm(x @ p.wq_a, p.q_norm, cfg.norm_eps) @ p.wq_b
    else:
        q = x @ p.wq
    q = q.reshape(b, s, h, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)

    kv = x @ p.wkv_a                                          # (B, S, kr + rope)
    ckv = L.rms_norm(kv[..., :kr], p.kv_norm, cfg.norm_eps)
    krope = L.apply_rope(kv[..., kr:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0]

    if cache is not None:
        ckv_all, krope_all = cache["ckv"], cache["krope"]
        ckv_all[:, cache_len:cache_len + s] = ckv.to(ckv_all.dtype)
        krope_all[:, cache_len:cache_len + s] = krope.to(krope_all.dtype)
    else:
        ckv_all, krope_all = ckv, krope
    t = ckv_all.shape[1]
    decode = cache is not None and s == 1

    if cfg.mla_absorbed_decode and decode:
        # attention against the latent cache: O(T kv_rank H) a token
        wk_b = p.wk_b.reshape(kr, h, nope).float()
        wv_b = p.wv_b.reshape(kr, h, vdim).float()
        q_abs = torch.einsum("bshn,rhn->bshr", q_nope.float(), wk_b)        # (B, 1, H, kr)
        logits = (torch.einsum("bshr,btr->bhst", q_abs, ckv_all.float())
                  + torch.einsum("bshp,btp->bhst", q_rope.float(), krope_all.float())
                  ) / (nope + rope_d) ** 0.5
        written = torch.arange(t, device=x.device)[None, None, None, :] < cache_len + s
        w = torch.softmax(logits.masked_fill(~written, float("-inf")), dim=-1)
        ctx_lat = torch.einsum("bhst,btr->bshr", w, ckv_all.float())         # (B, 1, H, kr)
        out = torch.einsum("bshr,rhv->bshv", ctx_lat, wv_b)
        return out.reshape(b, s, h * vdim).to(x.dtype) @ p.wo

    # materialized K / V: a decode step expands the latent in float32 (the
    # bf16 rounding of re-materialised K / V is what separates this path
    # from the absorbed one); prefill keeps the cache's dtype
    lat = ckv_all.float() if decode else ckv_all
    k_nope = (lat @ p.wk_b.to(lat.dtype)).reshape(b, t, h, nope)
    v = (lat @ p.wv_b.to(lat.dtype)).reshape(b, t, h, vdim)
    krope_b = krope_all[:, :, None, :].to(k_nope.dtype).expand(b, t, h, rope_d)
    k_full = torch.cat([k_nope, krope_b], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1).to(k_full.dtype)
    del k_nope, krope_b
    written = None if cache is None else cache_len + s
    out = L.attention_core(q_full, k_full, v, 0 if cache is None else cache_len, cfg,
                           written_upto=written)
    return out.reshape(b, s, h * vdim).to(x.dtype) @ p.wo
