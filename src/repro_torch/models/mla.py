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

The cache is written in place, as the port's GQA cache.  Under a mesh
context (`mla_attention`) a rank computes the heads its rows of wo cover
from the whole latents (`mla_latents`' column blocks gathered over
`model`), its partial reduced over `model`; `mla_local` is the rank's
part with no collective.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import ctx as mesh_ctx
from repro_torch.sharding import tp


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


def mla_latents(p, x: torch.Tensor):
    """The projections into the latents: (x @ wq_a, or None without a q
    bottleneck; x @ wkv_a), each the rank's column block under a mesh
    (the whole projection without one)."""
    return (x @ p.wq_a if hasattr(p, "wq_a") else None), x @ p.wkv_a


def _weight_heads(w: torch.Tensor, n_heads: int, hd: int, rank: int, n_model: int, gather):
    """A (rows, heads x hd) weight as (rows, heads, hd) and its first head:
    whole, the rank's whole heads, or (a block that splits heads) gathered
    whole by `gather`."""
    if w.shape[1] == n_heads * hd:
        return w.reshape(w.shape[0], n_heads, hd), 0
    if n_heads % n_model == 0:
        per = n_heads // n_model
        return w.reshape(w.shape[0], per, hd), rank * per
    return gather(w).reshape(w.shape[0], n_heads, hd), 0


def mla_local(p, x: torch.Tensor, q_lat, kv_lat: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, rank: int = 0, n_model: int = 1, cache: dict | None = None,
              cache_len: int = 0, share=None, gather=None, seq=None) -> torch.Tensor:
    """One rank's MLA from the whole latents (`mla_latents`' outputs, whole:
    gathered over `model` by the wrapper), with no collective of its own
    but `gather`.  `p` holds the rank's blocks: wq_b / wk_b / wv_b (and wq)
    column blocks or whole, wo a row block or whole; q_norm and kv_norm
    whole.  Returns the rank's partial (B, S, d): the heads its rows of wo
    cover, times those rows (the whole output when wo is whole).

    The latents are normalized whole and the whole latent and rope key go
    into the cache (every rank writes the same).  A projection whose block
    splits heads needs `gather` (its block -> the whole projection over
    `model`).  `share` (the wrapper's `replicated_input`) marks where a
    replicated tensor meets work of the rank's own: the input of a column
    block, and, where the rank computes a subset of the heads, a whole
    projection's output and the rope key.  With rank 0 of 1 and whole
    weights this is the unsharded MLA.

    `seq` (`tp.SeqShard`): the cache holds the rank's latent slots [seq.lo,
    seq.lo + T) of seq.whole, the batch whole on every rank: a token's
    latent is written by the rank that owns its slot; a prefill attends
    over the prompt's own latents (on the whole cache's flash condition);
    both decode paths take the softmax partials over the rank's slots
    (the materialized one expands K / V from those slots only), gathered
    by `seq.exchange` and summed in rank order (`layers.combine_partials`)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope_d, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank
    partial = p.wo.shape[0] != h * vdim
    if partial:
        rows = p.wo.shape[0]
        c0 = rank * rows
        h_lo, h_hi = c0 // vdim, -(-(c0 + rows) // vdim)
    else:
        c0, rows, h_lo, h_hi = 0, h * vdim, 0, h

    def mark(t, yes: bool):
        return share(t) if yes and share is not None else t

    def proj(inp, w, hd):
        """The heads [h_lo, h_hi) of inp @ w (B, L, ·, hd)."""
        is_block = w.shape[1] != h * hd
        y, lo = L._project(mark(inp, is_block), w, None, h, hd, rank, n_model, gather)
        return mark(y, partial and not is_block)[:, :, h_lo - lo:h_hi - lo]

    if q_lat is not None:
        q = proj(L.rms_norm(q_lat, p.q_norm, cfg.norm_eps), p.wq_b, nope + rope_d)
    else:
        q = proj(x, p.wq, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)

    ckv = L.rms_norm(kv_lat[..., :kr], p.kv_norm, cfg.norm_eps)
    krope = L.apply_rope(kv_lat[..., kr:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0]

    if cache is not None:
        ckv_all, krope_all = cache["ckv"], cache["krope"]
        if seq is None:
            ckv_all[:, cache_len:cache_len + s] = ckv.to(ckv_all.dtype)
            krope_all[:, cache_len:cache_len + s] = krope.to(krope_all.dtype)
        else:
            L.write_slots(ckv_all, ckv, cache_len, seq.lo)
            L.write_slots(krope_all, krope, cache_len, seq.lo)
    else:
        ckv_all, krope_all = ckv, krope
    nh = h_hi - h_lo
    decode = cache is not None and s == 1
    # over a sequence-sharded cache: a prefill reads the prompt's own
    # latents, any other step the rank's slots (partials)
    seq_prefill = seq is not None and s > 1 and cache_len == 0
    if seq_prefill:
        ckv_all, krope_all = ckv.to(ckv_all.dtype), krope.to(krope_all.dtype)
    t = ckv_all.shape[1]
    slot_pos = (None if seq is None or seq_prefill
                else seq.lo + torch.arange(t, device=x.device))

    if cfg.mla_absorbed_decode and decode:
        # attention against the latent cache: O(T kv_rank H) a token
        wk_b, k_lo = _weight_heads(p.wk_b, h, nope, rank, n_model, gather)
        wv_b, v_lo = _weight_heads(p.wv_b, h, vdim, rank, n_model, gather)
        wk_b = wk_b[:, h_lo - k_lo:h_hi - k_lo].float()
        wv_b = wv_b[:, h_lo - v_lo:h_hi - v_lo].float()
        q_abs = torch.einsum("bshn,rhn->bshr", q_nope.float(), wk_b)        # (B, 1, nh, kr)
        logits = (torch.einsum("bshr,btr->bhst", q_abs, ckv_all.float())
                  + torch.einsum("bshp,btp->bhst", q_rope.float(), krope_all.float())
                  ) / (nope + rope_d) ** 0.5
        if slot_pos is None:
            written = torch.arange(t, device=x.device)[None, None, None, :] < cache_len + s
            w = torch.softmax(logits.masked_fill(~written, float("-inf")), dim=-1)
            ctx_lat = torch.einsum("bhst,btr->bshr", w, ckv_all.float())     # (B, 1, nh, kr)
        else:
            mask = L.seq_mask(s, cache_len, slot_pos, cfg, cache_len + s)
            part = L.softmax_partials(
                logits + mask, lambda p: torch.einsum("bhst,btr->bhsr", p, ckv_all.float()))
            ctx_lat = L.combine_partials(seq.exchange(part)).transpose(1, 2)
        out = torch.einsum("bshr,rhv->bshv", ctx_lat, wv_b).reshape(b, s, nh * vdim)
        out = out[..., c0 - h_lo * vdim:c0 - h_lo * vdim + rows]
        return out.to(x.dtype) @ p.wo

    # materialized K / V: a decode step expands the latent in float32 (the
    # bf16 rounding of re-materialised K / V is what separates this path
    # from the absorbed one); prefill keeps the cache's dtype
    lat = ckv_all.float() if decode else ckv_all
    k_nope = proj(lat, p.wk_b.to(lat.dtype), nope)
    v = proj(lat, p.wv_b.to(lat.dtype), vdim)
    krope_b = mark(krope_all, partial)[:, :, None, :].to(k_nope.dtype).expand(b, t, nh,
                                                                             rope_d)
    k_full = torch.cat([k_nope, krope_b], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1).to(k_full.dtype)
    del k_nope, krope_b
    if slot_pos is not None:
        out = L.seq_attention(q_full, k_full, v,
                              L.seq_mask(s, cache_len, slot_pos, cfg, cache_len + s), seq)
    elif seq_prefill:
        out = L.attention_core(q_full, k_full, v, 0, cfg, flash_t=seq.whole)
    else:
        written = None if cache is None else cache_len + s
        out = L.attention_core(q_full, k_full, v, 0 if cache is None else cache_len, cfg,
                               written_upto=written)
    out = out.reshape(b, s, nh * vdim)[..., c0 - h_lo * vdim:c0 - h_lo * vdim + rows]
    return out.to(x.dtype) @ p.wo


def mla_attention(p: MLA, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                  cache: dict | None = None, cache_len: int = 0) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d).  cache: None, or {"ckv": (B, S_max,
    kv_rank), "krope": (B, S_max, rope)}, written in place at
    [cache_len, cache_len + S).

    Under a mesh context the weights are the rank's blocks (`sharding.tp`):
    gathered over `data` under fsdp; the latents' column blocks (wq_a's,
    wkv_a's) gathered over `model` (sites "mla_q_a", "mla_kv_a"), since
    each needs an RMS norm over its whole width and the kv block may
    straddle the latent / rope-key boundary; then `mla_local` on the rank's
    heads, its partial reduced over `model` ("mla_out") where wo's rows
    split.  The cache holds the whole latent and rope key on every rank, or,
    where the context's batch is whole, the rank's slots of them
    (`tp.seq_shard`; one counted all-gather of a decode's partials a batch
    axis of more than one rank, site "attn_seq").

    Gradients: a replicated tensor is marked by `replicated_input` (site
    "mla_in") where work of the rank's own reads it (x before a column
    block, the normalized latents before the head projections), so its
    gradient, and a replicated parameter's behind it (q_norm, kv_norm), is
    the sum of the ranks' shares once; the latents' gathers keep the
    rank's block of that (already whole) gradient (`gather_replicated`)."""
    if mesh_ctx.current() is None:
        q_a, kv_a = mla_latents(p, x)
        return mla_local(p, x, q_a, kv_a, positions, cfg, cache=cache, cache_len=cache_len)
    w = tp.gathered(p)
    specs = w.specs
    share = lambda t: tp.replicated_input(t, "mla_in")  # noqa: E731
    split = {n: tp.over_model(sp) for n, sp in specs.items()}
    xs = share(x) if split.get("wq_a") or split["wkv_a"] else x

    def latent(name, site):
        """x @ the latent projection, whole: its column blocks gathered."""
        if not split[name]:
            return x @ getattr(w, name)
        return tp.gather_model_replicated(xs @ getattr(w, name), -1, site)

    q_a = latent("wq_a", "mla_q_a") if "wq_a" in specs else None
    kv_a = latent("wkv_a", "mla_kv_a")
    partial = split["wo"]
    gather = ((lambda t: tp.gather_model(t, -1, "mla_heads")) if partial
              else (lambda t: tp.gather_model_replicated(t, -1, "mla_heads")))
    out = mla_local(w, x, q_a, kv_a, positions, cfg, tp.rank(tp.MODEL), tp.size(tp.MODEL),
                    cache=cache, cache_len=cache_len, share=share, gather=gather,
                    seq=None if cache is None else tp.seq_shard(cache["ckv"]))
    return tp.reduce_model(out, "mla_out") if partial else out
