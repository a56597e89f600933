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
from repro_torch.sharding import ctx as mesh_ctx
from repro_torch.sharding import tp

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
    sec_id = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                          device=x.device)
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


# --------------------------------------------------------------------------
# Decode over a sequence-sharded cache: each rank's softmax partials over its
# slots, combined in rank order
# --------------------------------------------------------------------------

def softmax_partials(logits: torch.Tensor, values) -> torch.Tensor:
    """The partial softmax of masked float32 `logits` (..., T) over one
    rank's T slots: (..., Dv + 2) float32 holding the unnormalised output
    `values(p)` (..., Dv) with p = exp(logits - m), then the row max m and
    the sum l of p.  A row with no kept slot has m = -inf, l = 0 and o =
    0."""
    m = logits.amax(-1)
    p = torch.exp(logits - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    return torch.cat([values(p), m[..., None], p.sum(-1)[..., None]], dim=-1)


def combine_partials(parts: torch.Tensor) -> torch.Tensor:
    """Every rank's `softmax_partials` stacked (n, ..., Dv + 2) in rank order
    -> the softmax-weighted output (..., Dv) float32: each rank's o and l
    scaled by exp(m_r - max m) and summed in rank order, so every rank
    that combines the same gathered partials holds the same numbers.  A
    rank with no kept slot adds nothing; a row no rank keeps gives 0."""
    o, m, l = parts[..., :-2], parts[..., -2], parts[..., -1]
    big = m.amax(0)
    big = torch.where(torch.isfinite(big), big, 0.0)
    acc = torch.zeros_like(o[0])
    den = torch.zeros_like(l[0])
    for r in range(parts.shape[0]):
        a = torch.exp(m[r] - big)                 # 0 where m_r = -inf
        acc = acc + a[..., None] * o[r]
        den = den + a * l[r]
    return acc / torch.clamp_min(den, 1e-30)[..., None]


def sdpa_partials(q, k, v, mask) -> torch.Tensor:
    """`_sdpa`'s float32 logits over one rank's slots (q (B, S, H, D), k / v
    (B, T, KV, D), the additive (S, T) mask) as `softmax_partials`: (B, S,
    H, Dv + 2)."""
    b, s, h, dd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, dd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / dd ** 0.5
    part = softmax_partials(logits + mask,
                            lambda p: torch.einsum("bkgst,btkd->bkgsd", p, v.float()))
    return part.permute(0, 3, 1, 2, 4).reshape(b, s, h, part.shape[-1])


def seq_mask(s: int, q_offset: int, kv_positions: torch.Tensor, cfg: ModelConfig,
             written_upto: int | None = None) -> torch.Tensor:
    """The (s, T) additive mask of a rank's slots at absolute positions
    `kv_positions` (< 0: never written), query rows from `q_offset`: the
    causal and window rules, and slots at or past `written_upto`."""
    mask = _attention_mask(s, kv_positions.shape[0], q_offset, cfg,
                           kv_positions=kv_positions, device=kv_positions.device)
    dead = kv_positions < 0
    if written_upto is not None:
        dead = dead | (kv_positions >= written_upto)
    return mask.masked_fill(dead[None, :], float("-inf"))


def write_slots(leaf: torch.Tensor, new: torch.Tensor, first: int, lo: int) -> None:
    """Write `new` (B, s, ...) at the whole cache's slots [first, first + s)
    into `leaf`, a rank's block of slots [lo, lo + T): only the slots the
    block owns."""
    t, s = leaf.shape[1], new.shape[1]
    a, b = max(first, lo), min(first + s, lo + t)
    if a < b:
        leaf[:, a - lo:b - lo] = new[:, a - first:b - first].to(leaf.dtype)


def seq_attention(q, k, v, mask, seq) -> torch.Tensor:
    """q over a rank's slots k / v under `mask` (`seq_mask`), combined with
    every rank's over theirs (`seq.exchange`, then `combine_partials`):
    (B, S, H, Dv) in q's dtype, the whole cache's softmax attention."""
    return combine_partials(seq.exchange(sdpa_partials(q, k, v, mask))).to(q.dtype)


def attention_core(q, k, v, q_offset: int, cfg: ModelConfig, kv_positions=None,
                   written_upto: int | None = None, flash_t: int | None = None):
    """Dispatch between the dense-mask and flash paths, on the reference's
    condition, which reads the key length `flash_t` (default k's: a
    prefill into a sequence-sharded cache attends over the prompt's own
    keys and passes the whole cache's).  The flash path is
    `ops.flash_attention`: the CUDA kernel on a CUDA tensor (whatever
    `use_pallas_attention` says), its plain version on the CPU; where
    autograd records (the training forward), it goes through
    `ops.FlashAttentionFn`, whose backward recomputes the plain version
    chunk by chunk (chunk cfg.flash_chunk)."""
    s, t = q.shape[1], k.shape[1]
    ft = t if flash_t is None else flash_t
    thresh = cfg.flash_threshold or FLASH_THRESHOLD
    chunk = cfg.flash_chunk or FLASH_CHUNK
    use_flash = (s > 1 and ft >= thresh and ft % chunk == 0 and kv_positions is None)
    if use_flash:
        # a rank whose query heads read some of the cache's kv heads gets a
        # strided slice of them (`_kv_for`); the kernel takes whole rows
        k, v = k.contiguous(), v.contiguous()
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


def _project(x, w, b, n_heads: int, hd: int, rank: int, n_model: int, gather):
    """x @ w (+ b) as (B, S, heads, hd) and its first head: the whole
    projection (w has n_heads * hd columns), the rank's column block when
    its heads are whole (n_model divides n_heads), else the block gathered
    over `model` by `gather` into whole heads."""
    bsz, s, _ = x.shape
    y = x @ w
    if b is not None:
        y = y + b
    cols = w.shape[1]
    if cols == n_heads * hd:
        return y.reshape(bsz, s, n_heads, hd), 0
    if cols * n_model != n_heads * hd:
        raise ValueError(f"a {cols}-column block of a {n_heads * hd}-column projection on a "
                         f"{n_model}-rank model axis")
    if n_heads % n_model == 0:
        per = n_heads // n_model
        return y.reshape(bsz, s, per, hd), rank * per
    if gather is None:
        raise ValueError(f"{n_heads} heads over a {n_model}-rank model axis split heads: the "
                         f"projection's block is gathered over `model` (attention's "
                         f"wrapper)")
    return gather(y).reshape(bsz, s, n_heads, hd), 0


def _kv_for(k, k_lo: int, h_lo: int, h_hi: int, group: int):
    """The kv heads of query heads [h_lo, h_hi) from k (B, T, n, D) holding
    kv heads from k_lo: a slice when the queries group evenly over them
    (query i of the slice reads kv head i // (n_q / n_kv), as the GQA
    paths take it), else one kv head a query."""
    kv_lo, kv_hi = h_lo // group, (h_hi - 1) // group + 1
    sl = k[:, :, kv_lo - k_lo:kv_hi - k_lo]
    if kv_hi - kv_lo == 1 or (h_lo % group == 0 and (h_hi - h_lo) % group == 0):
        return sl
    idx = torch.arange(h_lo, h_hi, device=k.device) // group - kv_lo
    return sl[:, :, idx]


def attention_local(p, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                    rank: int = 0, n_model: int = 1, cache: dict | None = None,
                    cache_len: int = 0, positions3: torch.Tensor | None = None,
                    share=None, gather=None, seq=None) -> torch.Tensor:
    """One rank's attention with no collective: `p` holds the rank's blocks
    (wq / wk / wv (d, ·) column blocks, or whole; wo (·, d) a row block,
    or whole; the biases with their columns), `rank` / `n_model` its
    `model` coordinate.  Returns the rank's partial (B, S, d): its heads'
    output times its rows of wo (the whole output when wo is whole).

    The heads a rank computes are those its rows of wo cover.  A
    projection whose block splits heads (the head count does not divide
    the axis) needs `gather` (its block -> the whole projection; the
    wrapper's counted gather over `model`).  `share` (the wrapper's
    `replicated_input`) marks the replicated tensors that feed the rank's
    partial: x before a column block, and a whole projection's output.
    The cache holds the kv heads the rank has: its block's, or all of
    them where its block split heads.  With rank 0 of 1 and whole weights
    this is the unsharded attention.

    `seq` (`tp.SeqShard`): the cache holds the rank's slots [seq.lo, seq.lo
    + T) of seq.whole, the batch whole on every rank.  A token is written
    by the rank that owns its slot (the ring's p mod W); a prefill attends
    over the prompt's own keys, a decode step over the rank's slots, each
    masked by its absolute position, as `sdpa_partials` whose every
    rank's partials `seq.exchange` gathers and `combine_partials` sums in
    rank order."""
    b, s, _ = x.shape
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    partial = p.wo.shape[0] != h * hd
    blocks = [w.shape[1] != n * hd for w, n in ((p.wq, h), (p.wk, kvh), (p.wv, kvh))]
    x_in = share(x) if (partial and share is not None and any(blocks)) else x

    def proj(w, bias, n, is_block):
        y, lo = _project(x_in if is_block else x, w, bias, n, hd, rank, n_model, gather)
        if partial and not is_block and share is not None:
            y = share(y)
        return y, lo

    bias = cfg.qkv_bias
    q, q_lo = proj(p.wq, p.bq if bias else None, h, blocks[0])
    k, k_lo = proj(p.wk, p.bk if bias else None, kvh, blocks[1])
    v, _ = proj(p.wv, p.bv if bias else None, kvh, blocks[2])
    if partial:
        rows = p.wo.shape[0]
        c0 = rank * rows
        h_lo, h_hi = c0 // hd, -(-(c0 + rows) // hd)
    else:
        c0, rows, h_lo, h_hi = 0, h * hd, 0, h
    q = q[:, :, h_lo - q_lo:h_hi - q_lo]

    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.pos_emb == "mrope":
        q = apply_mrope(q, positions3, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions3, cfg.rope_theta, cfg.mrope_sections)

    group = h // kvh

    def kv(t):
        return _kv_for(t, k_lo, h_lo, h_hi, group)

    if cache is None:
        out = attention_core(q, kv(k), kv(v), 0, cfg)
    else:
        ck, cv = cache["k"], cache["v"]
        if ck.shape[2] != k.shape[2]:
            raise ValueError(f"the cache holds {ck.shape[2]} kv heads; this rank's "
                             f"projection gives {k.shape[2]} (init_cache under the mesh)")
        s_max = ck.shape[1] if seq is None else seq.whole
        lo = 0 if seq is None else seq.lo
        slots = lo + torch.arange(ck.shape[1], device=x.device)
        if cfg.sliding_window and s_max <= cfg.sliding_window:
            # ring buffer: slot(p) = p mod W; after the write, slot j holds
            # absolute position last - ((last - j) mod W) (< 0: never written)
            last = cache_len + s - 1
            slot_pos = last - torch.remainder(last - slots, s_max)
            if s == 1:
                write_slots(ck, k, cache_len % s_max, lo)
                write_slots(cv, v, cache_len % s_max, lo)
                if seq is None:
                    out = attention_core(q, kv(ck), kv(cv), cache_len, cfg,
                                         kv_positions=slot_pos)
                else:
                    out = seq_attention(q, kv(ck), kv(cv),
                                        seq_mask(s, cache_len, slot_pos, cfg), seq)
            else:
                # prefill: place the last W tokens at their ring slots (the
                # rank's slots of the ring); the attention runs over the full
                # (windowed) sequence
                gather_idx = torch.clamp(slot_pos, 0, s - 1)
                ck.copy_(k[:, gather_idx].to(ck.dtype))
                cv.copy_(v[:, gather_idx].to(cv.dtype))
                out = attention_core(q, kv(k), kv(v), 0, cfg)
        elif seq is None:
            ck[:, cache_len:cache_len + s] = k.to(ck.dtype)
            cv[:, cache_len:cache_len + s] = v.to(cv.dtype)
            out = attention_core(q, kv(ck), kv(cv), cache_len, cfg,
                                 written_upto=cache_len + s)
        else:
            write_slots(ck, k, cache_len, lo)
            write_slots(cv, v, cache_len, lo)
            if s > 1 and cache_len == 0:
                # prefill: the prompt's own keys (the batch is whole on the
                # rank), on the whole cache's flash condition
                out = attention_core(q, kv(k), kv(v), 0, cfg, flash_t=s_max)
            else:
                out = seq_attention(q, kv(ck), kv(cv),
                                    seq_mask(s, cache_len, slots, cfg, cache_len + s), seq)
    out = out.reshape(b, s, (h_hi - h_lo) * hd)
    if partial:
        out = out[..., c0 - h_lo * hd:c0 - h_lo * hd + rows]
    return out @ p.wo


def attention(p: Attention, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, cache: dict | None = None, cache_len: int = 0,
              positions3: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence (prefill) or incremental (decode) attention.

    cache: None, or {"k": (B, S_max, KV, D), "v": ...}, written in place:
    at [cache_len, cache_len + S) for the linear cache, or at ring slots
    p mod S_max when cfg.sliding_window >= S_max (the reference's ring).
    Returns the attention output (B, S, d).

    Under a mesh context the weights are the rank's blocks (`sharding.tp`):
    gathered over `data` under fsdp, then `attention_local` on the rank's
    heads with its counted collectives, and the partial reduced over
    `model` where wo's rows split over it.  A cache whose sequence splits
    over the batch axes (`tp.seq_shard`: the context's batch is whole)
    takes one counted all-gather of the decode's partials a batch axis of
    more than one rank (site "attn_seq")."""
    if mesh_ctx.current() is None:
        return attention_local(p, x, positions, cfg, cache=cache, cache_len=cache_len,
                               positions3=positions3)
    w = tp.gathered(p)
    if cfg.qkv_bias:
        # the specs split a bias over `model` whatever its matrix's layout:
        # under replicate_misaligned_heads a whole matrix's bias is gathered,
        # and every rank computes with it alike (its gradient whole on each)
        for m, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
            if tp.over_model(w.specs[b]) and not tp.over_model(w.specs[m]):
                setattr(w, b, tp.gather_model_replicated(getattr(w, b), 0, "attn_bias"))
    out = attention_local(w, x, positions, cfg, tp.rank(tp.MODEL), tp.size(tp.MODEL),
                          cache=cache, cache_len=cache_len, positions3=positions3,
                          share=lambda t: tp.replicated_input(t, "attn_in"),
                          gather=lambda t: tp.gather_model(t, -1, "attn_heads"),
                          seq=None if cache is None else tp.seq_shard(cache["k"]))
    return tp.reduce_model(out, "attn_out") if tp.over_model(w.specs["wo"]) else out


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


def mlp_local(p, x: torch.Tensor) -> torch.Tensor:
    """The FFN on whatever blocks `p` holds (wi / wg column blocks and wo's
    rows: the rank's partial; whole: the FFN), with no collective."""
    if getattr(p, "wg", None) is not None:  # SwiGLU
        return (nn.functional.silu(x @ p.wg) * (x @ p.wi)) @ p.wo
    h = torch.relu(x @ p.wi)  # squared ReLU (nemotron family)
    return (h * h) @ p.wo


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """The FFN; under a mesh context on the rank's blocks: gathered over
    `data` under fsdp, and where the FFN dim splits over `model`, x as
    the replicated input and the partial reduced over `model`.  Under
    replicate_misaligned_heads the specs keep wo whole over `model` where
    the heads do not divide it (the reference's rule names the FFN's wo
    with attention's) while wi / wg stay column blocks: the rank then
    takes its rows of the whole wo, whose gradient sums the ranks' rows
    (site "mlp_wo")."""
    if mesh_ctx.current() is None:
        return mlp_local(p, x)
    w = tp.gathered(p)
    if not tp.over_model(w.specs["wi"]):
        return mlp_local(w, x)
    if not tp.over_model(w.specs["wo"]):
        rows = w.wi.shape[1]
        w.wo = tp.replicated_input(w.wo, "mlp_wo").narrow(0, tp.rank(tp.MODEL) * rows, rows)
    return tp.reduce_model(mlp_local(w, tp.replicated_input(x, "mlp_in")), "mlp_out")
