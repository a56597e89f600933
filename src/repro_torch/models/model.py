"""Model assembly (port of `repro.models.model`): embedding -> stack of
decoder layers -> head, with prefill and decode through a KV cache.

The reference groups layers into scanned units; the port keeps the unit
schedule (`unit_spec`) for parity and runs the layers as a `ModuleList`,
one Python loop.  Ported layer kind: ("attn", "dense"), the dense GQA
family.  MLA, MoE and Mamba layers raise NotImplementedError naming
ROADMAP A10.  No training path (no remat, no losses): `train/` is A10 too.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


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
    return "dense" if cfg.d_ff else "none"


def unit_spec(cfg: ModelConfig) -> UnitSpec:
    kinds = [(_mixer_kind(cfg, i), _ffn_kind(cfg, i))
             for i in range(cfg.n_layers)]
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


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a config with layers the port does not have yet."""
    for i in range(cfg.n_layers):
        kind = (_mixer_kind(cfg, i), _ffn_kind(cfg, i))
        if kind != ("attn", "dense"):
            raise NotImplementedError(
                f"{cfg.name}: layer {i} is {kind}; only ('attn', 'dense') "
                f"layers are ported (ROADMAP A10: MLA, MoE, SSM)")
    if cfg.mtp_depth:
        raise NotImplementedError(f"{cfg.name}: MTP heads are not ported "
                                  f"(ROADMAP A10)")


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        dt = L.dtype_of(cfg)
        self.norm1 = nn.Parameter(torch.ones(cfg.d_model, dtype=dt, device=device))
        self.norm2 = nn.Parameter(torch.ones(cfg.d_model, dtype=dt, device=device))
        self.mixer = L.init_attention(generator, cfg, device)
        self.ffn = L.init_mlp(generator, cfg, device)


class LM(nn.Module):
    """Parameters of a dense decoder LM: `embed` (vocab, d), `final_norm`,
    `lm_head` (d, vocab) unless cfg.tie_embeddings, and `layers`."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        dt = L.dtype_of(cfg)
        embed = torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                            device=generator.device) * 0.02
        self.embed = nn.Parameter(embed.to(device=device, dtype=dt))
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, dtype=dt, device=device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                L.dense_init(generator, cfg.d_model, cfg.vocab, dt, device))
        self.layers = nn.ModuleList(DecoderLayer(cfg, generator, device)
                                    for _ in range(cfg.n_layers))
        self.requires_grad_(False)  # serving only: no autograd graph

    def forward(self, **kw) -> "ForwardResult":
        return forward(self, self.cfg, **kw)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                seed: int = 0, device=None) -> LM:
    """The model with weights drawn from `generator` (else a generator on
    `device` seeded with `seed`).  The reference draws from `jax.random`;
    parity with it goes through `convert.lm_params_from_numpy`."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    return LM(cfg, generator, device)


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device=None) -> list:
    """Zeroed KV cache: one {"k", "v"} pair of (batch, T, KV, D) tensors a
    layer, T = min(s_max, sliding_window) under a window, else s_max."""
    check_ported(cfg)
    device = resolve_device(device)
    dt = L.dtype_of(cfg)
    t = min(s_max, cfg.sliding_window) if cfg.sliding_window else s_max
    shape = (batch, t, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
            for _ in range(cfg.n_layers)]


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Token-embedding lookup (the reference's one-hot form under a mesh is
    not ported: no mesh)."""
    return embed[tokens.long()]


class ForwardResult(NamedTuple):
    logits: torch.Tensor
    cache: Optional[list]
    aux_loss: torch.Tensor
    hidden: torch.Tensor


@torch.no_grad()
def forward(params: LM, cfg: ModelConfig, tokens=None, embeds=None,
            positions=None, positions3=None, cache=None,
            cache_len: int | None = None) -> ForwardResult:
    """tokens: (B, S) integer and/or embeds: (B, P, d) prefix.

    cache / cache_len: incremental mode, the cache written in place at
    [cache_len, cache_len + S) (prefill: cache_len 0) and returned.  The
    logits are (B, S, vocab) float32, as in the reference."""
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
    for i, layer in enumerate(params.layers):
        h = L.rms_norm(x, layer.norm1, cfg.norm_eps)
        x = x + L.attention(layer.mixer, h, positions, cfg,
                            cache=None if cache is None else cache[i],
                            cache_len=cl, positions3=positions3)
        h = L.rms_norm(x, layer.norm2, cfg.norm_eps)
        x = x + L.mlp(layer.ffn, h)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = (x @ head).float()
    return ForwardResult(logits=logits, cache=cache,
                         aux_loss=torch.zeros((), device=x.device), hidden=x)
