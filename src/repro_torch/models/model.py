"""Model assembly (port of `repro.models.model`): embedding -> stack of
layers -> head, for all ten architectures of the reference, with prefill
and decode through a per-layer cache.

The reference groups layers into scanned units (deepseek-v3: 3 dense MLA
layers unrolled as a prefix, then MoE MLA units; jamba: units of 8 layers,
attention at slot 4 and MoE on odd slots).  The port keeps the unit
schedule (`unit_spec`) for parity and runs the layers as one `ModuleList`
in order: body slot j of unit u is layer n_prefix + u * len(kinds) + j.
A layer is (mixer, ffn): mixer "attn" (GQA), "mla" or "mamba", ffn
"dense", "moe" or "none" (pure mamba2 blocks).

deepseek-v3's MTP parameters (`mtp`: proj, block, norm) feed `mtp_loss`;
the serving forward never reads them.  Training: `LM.train_mode()` makes
the parameters trainable, `forward(..., train=True)` records autograd
(with cfg.remat each unit runs under `torch.utils.checkpoint`, as the
reference's `jax.checkpoint(unit_body)`; the prefix layers outside it),
and `cross_entropy` / `mtp_loss` are the reference's losses.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import ctx as mesh_ctx
from repro_torch.sharding import tp


class UnitSpec(NamedTuple):
    kinds: tuple            # tuple of (mixer_kind, ffn_kind) per slot
    n_prefix: int           # unrolled prefix layers
    n_units: int            # repeated units


def _mixer_kind(cfg: ModelConfig, i: int) -> str:
    if not cfg.is_attn_layer(i):
        return "mamba"
    return "mla" if cfg.attn_type == "mla" else "attn"


def _ffn_kind(cfg: ModelConfig, i: int) -> str:
    if cfg.is_moe_layer(i):
        return "moe"
    return "dense" if cfg.d_ff else "none"  # pure mamba2 blocks have no FFN


def layer_kind(cfg: ModelConfig, i: int) -> tuple:
    return (_mixer_kind(cfg, i), _ffn_kind(cfg, i))


def unit_spec(cfg: ModelConfig) -> UnitSpec:
    kinds = [layer_kind(cfg, i) for i in range(cfg.n_layers)]
    n_prefix = cfg.moe_layer_start if cfg.n_experts else 0
    body = kinds[n_prefix:]
    # the smallest period that tiles the body becomes the unit
    for u in range(1, len(body) + 1):
        if len(body) % u:
            continue
        unit = tuple(body[:u])
        if all(tuple(body[j:j + u]) == unit for j in range(0, len(body), u)):
            return UnitSpec(kinds=unit, n_prefix=n_prefix, n_units=len(body) // u)
    raise AssertionError("unreachable: the full body is always a period")


class Layer(nn.Module):
    """norm1, mixer, and (unless ffn is "none") norm2 and ffn."""

    def __init__(self, cfg: ModelConfig, kind: tuple, generator: torch.Generator, device):
        super().__init__()
        self.kind = kind
        mixer_kind, ffn_kind = kind
        dt = L.dtype_of(cfg)
        self.norm1 = nn.Parameter(torch.ones(cfg.d_model, dtype=dt, device=device))
        if mixer_kind == "attn":
            self.mixer = L.init_attention(generator, cfg, device)
        elif mixer_kind == "mla":
            self.mixer = MLA.init_mla(generator, cfg, device)
        else:
            self.mixer = SSM.init_mamba(generator, cfg, device)
        if ffn_kind != "none":
            self.norm2 = nn.Parameter(torch.ones(cfg.d_model, dtype=dt, device=device))
            self.ffn = (MOE.init_moe(generator, cfg, device) if ffn_kind == "moe"
                        else L.init_mlp(generator, cfg, device))


class MTP(nn.Module):
    """DeepSeek's multi-token-prediction head (depth 1): proj (2 d, d), one
    block of the last layer's mixer with a dense FFN, and a norm."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        dt = L.dtype_of(cfg)
        self.proj = nn.Parameter(L.dense_init(generator, 2 * cfg.d_model, cfg.d_model, dt,
                                              device))
        self.block = Layer(cfg, (_mixer_kind(cfg, cfg.n_layers - 1), "dense"), generator,
                           device)
        self.norm = nn.Parameter(torch.ones(cfg.d_model, dtype=dt, device=device))


class LM(nn.Module):
    """Parameters of an LM: `embed` (vocab, d), `final_norm`, `lm_head`
    (d, vocab) unless cfg.tie_embeddings, `layers` (prefix then body, in
    order) and `mtp` when cfg.mtp_depth."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        self.cfg = cfg
        dt = L.dtype_of(cfg)
        self.embed = nn.Parameter(L.normal_init(generator, (cfg.vocab, cfg.d_model), 0.02,
                                                torch.float32, device).to(dt))
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, dtype=dt, device=device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                L.dense_init(generator, cfg.d_model, cfg.vocab, dt, device))
        self.layers = nn.ModuleList(Layer(cfg, layer_kind(cfg, i), generator, device)
                                    for i in range(cfg.n_layers))
        if cfg.mtp_depth:
            self.mtp = MTP(cfg, generator, device)
        self.requires_grad_(False)  # serving: no autograd graph until train_mode()

    def train_mode(self, on: bool = True) -> "LM":
        """Make every parameter trainable (or frozen again, on=False);
        returns the model."""
        self.requires_grad_(on)
        return self

    def forward(self, **kw) -> "ForwardResult":
        return forward(self, self.cfg, **kw)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                seed: int = 0, device=None) -> LM:
    """The model with weights drawn from `generator` (else a generator on
    `device` seeded with `seed`).  The reference draws from `jax.random`;
    parity with it goes through `convert.lm_params_from_numpy`.  On the
    meta device nothing is drawn: the model holds shapes and dtypes only
    (the dry-run's and the specs' stand-in)."""
    device = resolve_device(device)
    if device.type == "meta":
        generator = None
    elif generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    return LM(cfg, generator, device)


def _init_layer_cache(cfg: ModelConfig, kind: tuple, batch: int, s_max: int, dtype,
                      device) -> dict:
    mixer_kind, _ = kind
    if mixer_kind == "attn":
        t = min(s_max, cfg.sliding_window) if cfg.sliding_window else s_max
        shape = (batch, t, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if mixer_kind == "mla":
        return MLA.init_mla_cache(cfg, batch, s_max, dtype, device)
    return SSM.init_mamba_cache(cfg, batch, dtype, device)


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device=None) -> list:
    """Zeroed cache, one dict a layer by its mixer: attention {"k", "v"}
    (batch, T, KV, D), T = min(s_max, sliding_window) under a window;
    MLA {"ckv", "krope"} (batch, s_max, ·); mamba {"conv" (batch, K-1,
    CH), "ssm" (batch, H, P, N) float32}.

    Under a mesh context a rank's block of the whole cache
    (`specs.cache_pspec`), each leaf carrying its spec as `pspec`:
    `batch` is the rank's; the batch splits over the batch axes, or,
    where the context's batch is whole (`ctx.batch_whole`), the sequence
    of k / v (the window's ring too) and of ckv / krope splits over them,
    where it divides; KV, CH and H split over `model` where they
    divide."""
    device = resolve_device(device)
    dt = L.dtype_of(cfg)
    ctx = mesh_ctx.current()
    if ctx is None:
        return [_init_layer_cache(cfg, layer_kind(cfg, i), batch, s_max, dt, device)
                for i in range(cfg.n_layers)]
    from repro_torch.launch.mesh import mesh_shape_dict
    from repro_torch.sharding import specs

    mesh_shape = mesh_shape_dict(ctx.mesh)
    whole_batch = batch if ctx.batch_whole else batch * tp.size(ctx.batch_axes)
    out = []
    for i in range(cfg.n_layers):
        layer = {}
        for name, leaf in _init_layer_cache(cfg, layer_kind(cfg, i), whole_batch, s_max,
                                            dt, "meta").items():
            spec = specs.cache_pspec(name, tuple(leaf.shape), mesh_shape, ctx.batch_axes,
                                     ctx.batch_whole)
            layer[name] = torch.zeros(specs.local_shape(leaf.shape, spec, mesh_shape),
                                      dtype=leaf.dtype, device=device)
            layer[name].pspec = spec
        out.append(layer)
    return out


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Token-embedding lookup.  Under a mesh context the table is the
    rank's rows of the vocab (`model`) and, under fsdp, its `data` slice of
    d (gathered first): ids outside the rank's rows read zero, and the
    lookups are summed over `model`.  One row is nonzero a token and
    adding zeros is exact, so this equals the reference's one-hot
    contraction (`src/repro/models/model.py:227-231`) and the gather."""
    if mesh_ctx.current() is None:
        return embed[tokens.long()]
    spec = tp.spec_of(embed)
    table = tp.whole_over_data(embed)
    if not tp.over_model(spec):
        return table[tokens.long()]
    out = embed_rows(table, tokens, tp.rank(tp.MODEL) * table.shape[0])
    return tp.reduce_model(out, "embed")


def embed_rows(rows: torch.Tensor, tokens: torch.Tensor, lo: int) -> torch.Tensor:
    """One rank's share of the vocab-parallel lookup: `rows` holds vocab
    rows [lo, lo + len(rows)); an id outside them reads zero."""
    local = tokens.long() - lo
    mine = (local >= 0) & (local < rows.shape[0])
    return rows[local.clamp(0, rows.shape[0] - 1)] * mine[..., None].to(rows.dtype)


def lm_logits(params: "LM", cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ the head (lm_head, or embed.T when tied), float32.
    Under a mesh context: the rank's vocab columns (vocab-sharded logits)
    where the vocab splits over `model`, with x as their replicated
    input."""
    if cfg.tie_embeddings:
        return head_logits(params.embed, True, x)
    return head_logits(params.lm_head, False, x)


def head_logits(w: torch.Tensor, tied: bool, x: torch.Tensor) -> torch.Tensor:
    """x @ w (lm_head), or x @ w.T where `tied` (the embed), float32;
    vocab-sharded as `lm_logits` says under a mesh context."""
    if mesh_ctx.current() is None:
        return (x @ (w.T if tied else w)).float()
    spec = tp.spec_of(w)
    head = tp.whole_over_data(w)
    if tp.over_model(spec):
        x = tp.replicated_input(x, "logits_in")
    return (x @ (head.T if tied else head)).float()


def vocab_lo(params: "LM", cfg: ModelConfig) -> int | None:
    """The first vocab id of the rank's logit columns where the mesh context
    shards the logits' vocab over `model`, else None: `tp.vocab_shard` of
    the head (lm_head, or the tied embed)."""
    if cfg.tie_embeddings:
        return tp.vocab_shard(params.embed, 0)
    return tp.vocab_shard(params.lm_head, 1)


class ForwardResult(NamedTuple):
    logits: torch.Tensor
    cache: Optional[list]
    aux_loss: torch.Tensor
    hidden: torch.Tensor


def _apply_layer(layer: Layer, x, positions, cfg: ModelConfig, cache, cache_len: int,
                 positions3):
    """One layer: x + mixer(norm1 x), then + ffn(norm2 x).  Returns (x,
    aux loss: the MoE's, else 0)."""
    mixer_kind, ffn_kind = layer.kind
    h = L.rms_norm(x, layer.norm1, cfg.norm_eps)
    if mixer_kind == "attn":
        y = L.attention(layer.mixer, h, positions, cfg, cache=cache, cache_len=cache_len,
                        positions3=positions3)
    elif mixer_kind == "mla":
        y = MLA.mla_attention(layer.mixer, h, positions, cfg, cache=cache, cache_len=cache_len)
    else:
        y = SSM.mamba_mixer(layer.mixer, h, cfg, cache=cache)
    x = x + y
    aux = torch.zeros((), device=x.device)
    if ffn_kind == "none":
        return x, aux
    h = L.rms_norm(x, layer.norm2, cfg.norm_eps)
    if ffn_kind == "moe":
        y, aux = MOE.moe_ffn(layer.ffn, h, cfg)
    else:
        y = L.mlp(layer.ffn, h)
    return x + y, aux


def forward(params: LM, cfg: ModelConfig, tokens=None, embeds=None,
            positions=None, positions3=None, cache=None,
            cache_len: int | None = None, train: bool = False) -> ForwardResult:
    """tokens (B, S) integer and / or embeds (B, P, d): the prefix (patch
    or frame embeddings) goes first.

    cache / cache_len: incremental mode, the cache written in place at
    [cache_len, cache_len + S) (prefill: cache_len 0) and returned.  Under
    M-RoPE, positions3 (3, B, S) defaults to the 1-D positions on all
    three axes, Qwen2-VL's ids for text (the reference needs it passed).
    The logits are (B, S, vocab) float32; aux_loss sums the MoE layers'
    in the reference's order (the prefix's, then each unit's sum).

    train=False (serving) runs under no_grad.  train=True records autograd
    (no cache); with cfg.remat each unit of the body runs under
    `torch.utils.checkpoint` (non-reentrant), so its activations are
    recomputed in the backward, the flash kernel among them."""
    if train and cache is not None:
        raise ValueError("forward(train=True) takes no cache")
    with torch.set_grad_enabled(train):
        return _forward(params, cfg, tokens, embeds, positions, positions3, cache,
                        cache_len, remat=train and cfg.remat)


def _forward(params: LM, cfg: ModelConfig, tokens, embeds, positions, positions3, cache,
             cache_len, remat: bool) -> ForwardResult:
    parts = []
    if embeds is not None:
        parts.append(embeds.to(L.dtype_of(cfg)))
    if tokens is not None:
        parts.append(embed_lookup(params.embed, tokens))
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    b, s, _ = x.shape
    cl = 0 if cache_len is None else int(cache_len)
    if positions is None:
        positions = (cl + torch.arange(s, device=x.device)).expand(b, s)
    if cfg.pos_emb == "mrope" and positions3 is None:
        positions3 = positions[None].expand(3, b, s)
    spec = unit_spec(cfg)
    aux_total = torch.zeros((), device=x.device)
    for i in range(spec.n_prefix):
        x, aux = _apply_layer(params.layers[i], x, positions, cfg,
                              None if cache is None else cache[i], cl, positions3)
        aux_total = aux_total + aux

    def unit(x, first: int):
        """Layers first .. first + len(kinds) - 1: x and their aux sum."""
        aux_unit = None
        for i in range(first, first + len(spec.kinds)):
            x, aux = _apply_layer(params.layers[i], x, positions, cfg,
                                  None if cache is None else cache[i], cl, positions3)
            aux_unit = aux if aux_unit is None else aux_unit + aux
        return x, aux_unit

    for u in range(spec.n_units):
        first = spec.n_prefix + u * len(spec.kinds)
        if remat:
            # the recomputation may run on autograd's device thread: it
            # reopens this thread's mesh context there
            x, aux_unit = torch.utils.checkpoint.checkpoint(
                unit, x, first, use_reentrant=False,
                context_fn=lambda: (contextlib.nullcontext(), mesh_ctx.reopened()))
        else:
            x, aux_unit = unit(x, first)
        aux_total = aux_total + aux_unit
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = lm_logits(params, cfg, x)
    return ForwardResult(logits=logits, cache=cache, aux_loss=aux_total, hidden=x)


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------

class _VocabParallelLogProb(torch.autograd.Function):
    """log softmax(logits)[label] of vocab-sharded float32 logits (N, V /
    n): the max and the sum of exp over `model`, the label's logit from
    the rank whose columns hold it (zero elsewhere), one all-reduce of the
    packed (sum, logit) pair.  Backward: (onehot - softmax) of the rank's
    columns times the gradient."""

    @staticmethod
    def forward(ctx, logits, labels, lo):
        from repro_torch.core.distributed import all_reduce

        mesh = mesh_ctx.current().mesh
        v = logits.shape[-1]
        mx = all_reduce(logits.detach().max(dim=-1).values, mesh, tp.MODEL, "ce_max",
                        op="max")
        shifted = logits.detach() - mx[:, None]
        e = torch.exp(shifted)
        local = labels.long() - lo
        mine = (local >= 0) & (local < v)
        picked = torch.gather(shifted, -1, local.clamp(0, v - 1)[:, None])[:, 0]
        picked = torch.where(mine, picked, torch.zeros_like(picked))
        sums = all_reduce(torch.stack([e.sum(-1), picked]), mesh, tp.MODEL, "ce")
        ctx.save_for_backward(e / sums[0][:, None], local, mine)
        return sums[1] - torch.log(sums[0])

    @staticmethod
    def backward(ctx, grad):
        probs, local, mine = ctx.saved_tensors
        g = -probs * grad[:, None]
        # + grad at each row's label column where the rank holds it (+ 0
        # elsewhere): no row count read back, so meta tensors take it too
        col = local.clamp(0, g.shape[-1] - 1)[:, None]
        g.scatter_add_(-1, col, torch.where(mine, grad, torch.zeros_like(grad))[:, None])
        return g, None, None


def _label_logprob(logits: torch.Tensor, labels: torch.Tensor, lo: int | None):
    """log softmax(logits)[label] of every row, float32: vocab-parallel
    where the logits are the rank's vocab columns from id `lo`."""
    if lo is None:
        logp = torch.log_softmax(logits, dim=-1)
        return torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    lead = labels.shape
    ll = _VocabParallelLogProb.apply(logits.reshape(-1, logits.shape[-1]),
                                     labels.reshape(-1), lo)
    return ll.reshape(lead)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None, *, vocab_lo: int | None) -> torch.Tensor:
    """Mean next-token negative log-likelihood of float32 logits (..., V)
    at integer labels; with a mask, the masked mean (denominator at least
    1).  `vocab_lo` (`vocab_lo(params, cfg)`, required) is None for whole
    logits, else the first vocab id of the rank's logit columns.

    Under a mesh context the logits and labels are the rank's data slice;
    over vocab shards the label's log-probability is the vocab-parallel
    log-sum-exp (exact against the reference's one-hot form at
    `src/repro/models/model.py:314-317`), and the mean is over the GLOBAL
    batch (the sums reduced over the batch axes, with a backward that
    keeps each rank's share), so the ranks' gradients summed over the
    batch axes are the unsharded gradient."""
    if vocab_lo is not None and mesh_ctx.current() is None:
        raise ValueError("vocab-sharded logits (vocab_lo set) need the mesh context")
    ll = _label_logprob(logits, labels, vocab_lo)
    if mesh_ctx.current() is None:
        if mask is None:
            return -torch.mean(ll)
        return -torch.sum(ll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    if mask is None:
        num, den = torch.sum(ll), torch.tensor(float(ll.numel()), device=ll.device)
    else:
        num, den = torch.sum(ll * mask), torch.sum(mask).float().detach()
    sums = tp.reduce_batch(torch.stack([num, den]), "loss")
    den = sums[1] if mask is None else torch.clamp_min(sums[1], 1.0)
    return -sums[0] / den


def mtp_loss(params: LM, cfg: ModelConfig, hidden: torch.Tensor, tokens: torch.Tensor,
             positions: torch.Tensor) -> torch.Tensor:
    """DeepSeek MTP (depth 1): predict token t+2 from [h_t ; emb(x_{t+1})]
    through the MTP block and the shared head (the embed's transpose).

    Under a mesh context: proj's column block of d (the residual stream)
    gathered over `model` (site "mtp_proj", keeping the rank's block of
    the whole gradient), its input marked replicated ("mtp_in"); the
    block runs the laid-out MLA and FFN; the shared head gives the rank's
    vocab columns from the embed's rows, as `lm_logits`, into the
    vocab-parallel loss."""
    if not cfg.mtp_depth:
        return torch.zeros((), device=hidden.device)
    p = params.mtp
    emb_next = embed_lookup(params.embed, tokens[:, 1:])            # (B, S-1, d)
    inp = torch.cat([hidden[:, :-1], emb_next], dim=-1)
    if mesh_ctx.current() is None:
        inp = inp @ p.proj
    elif tp.over_model(tp.spec_of(p.proj)):
        inp = tp.gather_model_replicated(tp.replicated_input(inp, "mtp_in")
                                         @ tp.whole_over_data(p.proj), -1, "mtp_proj")
    else:
        inp = inp @ tp.whole_over_data(p.proj)
    out, _ = _apply_layer(p.block, inp, positions[:, :-1], cfg, None, 0, None)
    out = L.rms_norm(out, p.norm, cfg.norm_eps)
    logits = head_logits(params.embed, True, out)                  # shared head
    return cross_entropy(logits[:, :-1], tokens[:, 2:],
                         vocab_lo=tp.vocab_shard(params.embed, 0))
