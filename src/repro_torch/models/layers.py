"""Shared transformer layers (port of `repro.models.layers`): RMS norm,
rotary embeddings (RoPE and M-RoPE), GQA attention with QKV bias, sliding
window and a KV cache, and the SwiGLU / squared-ReLU MLP.

Layers are `nn.Module`s whose weights keep the reference's (in, out)
layout, so `x @ w` reads as in the reference and a reference parameter
tree copies in unchanged (`repro_torch.convert.lm_params_from_numpy`).
dtype policy as in the reference: weights in cfg.dtype, norm, rotary and
softmax math in float32.  The KV cache is a preallocated (B, T, KV, D)
pair a layer, written in place where the reference returns an updated
copy.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig

# Above this KV length, prefill and training attention switch to the flash path:
# O(S * tile) live logits instead of O(S * T).
FLASH_THRESHOLD = 8192
FLASH_CHUNK = 2048

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def randn(generator: torch.Generator | None, shape, dtype=torch.float32) -> torch.Tensor:
    """N(0, 1) draws of `shape` on the generator's device; with no generator
    (a model built on the meta device: shapes and dtypes only) a meta
    tensor, nothing drawn."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.randn(shape, generator=generator, device=generator.device, dtype=dtype)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int, dtype,
               device) -> torch.Tensor:
    """N(0, 1/in_dim) (in, out) weight; the reference draws from
    `jax.random`, so parity goes through `convert`, not through init."""
    w = randn(generator, (in_dim, out_dim)) * in_dim ** -0.5
    return w.to(device=device, dtype=dtype)


def normal_init(generator: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    """N(0, scale^2) tensor of `shape` drawn directly in `dtype` (no float32
    copy: deepseek-v3's (256, 7168, 2048) expert stacks would need 15 GB
    of one), on the generator's device, then moved to `device`."""
    w = randn(generator, shape, dtype)
    return w.mul_(scale).to(device)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the (first half, second half) pairs of x (B, S, H, D) by the
    angles ang (B, S, D/2), in float32."""
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integer."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)        # (D/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the head-dim pair indices are split into
    (temporal, height, width) sections, each rotated by its own position id.

    x: (B, S, H, D); positions3: (3, B, S)."""
    d = x.shape[-1]
    half = d // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to {half}")
    freqs = rope_freqs(d, theta, device=x.device)                  # (half,)
    sec_id = torch.repeat_interleave(torch.arange(3, device=x.device),
                                     torch.tensor(sections, device=x.device))
    pos_per_pair = positions3.float()[sec_id]                      # (half, B, S)
    return _rotate(x, torch.movedim(pos_per_pair, 0, -1) * freqs)


# --------------------------------------------------------------------------
# Attention (GQA family)
# --------------------------------------------------------------------------

def _attention_mask(q_len: int, kv_len: int, q_offset: int, cfg: ModelConfig,
                    kv_positions: torch.Tensor | None = None, device=None):
    """(q_len, kv_len) additive float32 mask; q_offset is the absolute
    position of the first query row (decode: the cache length)."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    k_pos = (torch.arange(kv_len, device=device)[None, :] if kv_positions is None
             else kv_positions[None, :])
    ok = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if cfg.causal:
        ok &= k_pos <= q_pos
    if cfg.sliding_window:
        ok &= k_pos > q_pos - cfg.sliding_window
    return torch.zeros((q_len, kv_len), device=device).masked_fill(~ok, float("-inf"))


def _sdpa(q, k, v, mask):
    """q: (B, S, H, D), k / v: (B, T, KV, D) grouped; returns (B, S, H, D)."""
    b, s, h, dd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, dd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / dd ** 0.5
    w = torch.softmax(logits + mask, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(b, s, h, v.shape[-1]).to(q.dtype)


def attention_core(q, k, v, q_offset: int, cfg: ModelConfig, kv_positions=None,
                   written_upto: int | None = None):
    """Dispatch between the dense-mask and flash paths, on the reference's
    condition.  The flash path is `ops.flash_attention`: the CUDA kernel
    on a CUDA tensor (whatever `use_pallas_attention` says), its plain
    version on the CPU; where autograd records (the training forward), it
    goes through `ops.FlashAttentionFn`, whose backward recomputes the
    plain version chunk by chunk (chunk cfg.flash_chunk)."""
    s, t = q.shape[1], k.shape[1]
    thresh = cfg.flash_threshold or FLASH_THRESHOLD
    chunk = cfg.flash_chunk or FLASH_CHUNK
    use_flash = (s > 1 and t >= thresh and t % chunk == 0 and kv_positions is None)
    if use_flash:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return ops.FlashAttentionFn.apply(q, k, v, cfg.causal, cfg.sliding_window,
                                              int(q_offset), written_upto, chunk)
        return ops.flash_attention(q, k, v, causal=cfg.causal,
                                   window=cfg.sliding_window, q_offset=int(q_offset),
                                   written_upto=written_upto)
    mask = _attention_mask(s, t, q_offset, cfg, kv_positions=kv_positions,
                           device=q.device)
    if written_upto is not None:
        mask = mask.masked_fill(torch.arange(t, device=q.device)[None, :] >= written_upto,
                                float("-inf"))
    if kv_positions is not None:
        mask = mask.masked_fill(kv_positions[None, :] < 0, float("-inf"))
    return _sdpa(q, k, v, mask)


class Attention(nn.Module):
    """GQA attention: wq (d, H*hd), wk / wv (d, KV*hd), wo (H*hd, d), and
    bq / bk / bv when cfg.qkv_bias (zeros at init, as in the reference)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        dt = dtype_of(cfg)
        d, hd = cfg.d_model, cfg.head_dim
        self.wq = nn.Parameter(dense_init(generator, d, cfg.n_heads * hd, dt, device))
        self.wk = nn.Parameter(dense_init(generator, d, cfg.n_kv_heads * hd, dt, device))
        self.wv = nn.Parameter(dense_init(generator, d, cfg.n_kv_heads * hd, dt, device))
        self.wo = nn.Parameter(dense_init(generator, cfg.n_heads * hd, d, dt, device))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(cfg.n_heads * hd, dtype=dt, device=device))
            self.bk = nn.Parameter(torch.zeros(cfg.n_kv_heads * hd, dtype=dt, device=device))
            self.bv = nn.Parameter(torch.zeros(cfg.n_kv_heads * hd, dtype=dt, device=device))


def init_attention(generator: torch.Generator, cfg: ModelConfig, device) -> Attention:
    return Attention(cfg, generator, device)


def attention(p: Attention, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, cache: dict | None = None, cache_len: int = 0,
              positions3: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence (prefill) or incremental (decode) attention.

    cache: None, or {"k": (B, S_max, KV, D), "v": ...}, written in place:
    at [cache_len, cache_len + S) for the linear cache, or at ring slots
    p mod S_max when cfg.sliding_window >= S_max (the reference's ring).
    Returns the attention output (B, S, d)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)

    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.pos_emb == "mrope":
        q = apply_mrope(q, positions3, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions3, cfg.rope_theta, cfg.mrope_sections)

    if cache is None:
        out = attention_core(q, k, v, 0, cfg)
    else:
        ck, cv = cache["k"], cache["v"]
        s_max = ck.shape[1]
        if cfg.sliding_window and s_max <= cfg.sliding_window:
            # ring buffer: slot(p) = p mod W; after the write, slot j holds
            # absolute position last - ((last - j) mod W) (< 0: never written)
            last = cache_len + s - 1
            slots = torch.arange(s_max, device=x.device)
            slot_pos = last - torch.remainder(last - slots, s_max)
            if s == 1:
                slot = cache_len % s_max
                ck[:, slot:slot + 1] = k.to(ck.dtype)
                cv[:, slot:slot + 1] = v.to(cv.dtype)
                out = attention_core(q, ck, cv, cache_len, cfg, kv_positions=slot_pos)
            else:
                # prefill: place the last W tokens at their ring slots; the
                # attention runs over the full (windowed) sequence
                gather = torch.clamp(slot_pos, 0, s - 1)
                ck.copy_(k[:, gather].to(ck.dtype))
                cv.copy_(v[:, gather].to(cv.dtype))
                out = attention_core(q, k, v, 0, cfg)
        else:
            ck[:, cache_len:cache_len + s] = k.to(ck.dtype)
            cv[:, cache_len:cache_len + s] = v.to(cv.dtype)
            out = attention_core(q, ck, cv, cache_len, cfg,
                                 written_upto=cache_len + s)
    return out.reshape(b, s, cfg.n_heads * hd) @ p.wo


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU (wi, wg, wo) or, for cfg.ffn_act == "relu2", the squared-ReLU
    two-matrix FFN (wi, wo)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device,
                 d_ff: int | None = None):
        super().__init__()
        dt = dtype_of(cfg)
        d_ff = d_ff or cfg.d_ff
        self.wi = nn.Parameter(dense_init(generator, cfg.d_model, d_ff, dt, device))
        if cfg.ffn_act == "swiglu":
            self.wg = nn.Parameter(dense_init(generator, cfg.d_model, d_ff, dt, device))
        self.wo = nn.Parameter(dense_init(generator, d_ff, cfg.d_model, dt, device))


def init_mlp(generator: torch.Generator, cfg: ModelConfig, device,
             d_ff: int | None = None) -> MLP:
    return MLP(cfg, generator, device, d_ff)


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    if hasattr(p, "wg"):  # SwiGLU
        return (nn.functional.silu(x @ p.wg) * (x @ p.wi)) @ p.wo
    h = torch.relu(x @ p.wi)  # squared ReLU (nemotron family)
    return (h * h) @ p.wo
