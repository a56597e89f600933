"""Unified model configuration covering the 10 assigned architectures
(a copy of `repro.models.config`, which is pure Python; the port keeps
its own so that it imports nothing of the JAX package).

One frozen dataclass drives layer construction, parameter init, sharding
specs, KV/SSM cache layout and the dry-run input specs.  Families:

  dense GQA (minitron, yi, qwen2-72b, qwen1.5)      layer_pattern='attn'
  encoder   (hubert)                                causal=False
  MoE       (mixtral: SWA+8e, deepseek: MLA+256e)   n_experts>0
  SSM       (mamba2)                                layer_pattern='ssm'
  hybrid    (jamba: 1 attn : 7 mamba + MoE)         layer_pattern='jamba'
  VLM       (qwen2-vl: M-RoPE, stub patch frontend) pos_emb='mrope'
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                    # 0 -> d_model // n_heads

    # attention
    attn_type: str = "gqa"             # 'gqa' | 'mla'
    qkv_bias: bool = False
    sliding_window: int = 0            # 0 = full attention
    causal: bool = True                # False = bidirectional encoder
    rope_theta: float = 1e4
    pos_emb: str = "rope"              # 'rope' | 'mrope' | 'none'
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)

    # MoE
    ffn_act: str = "swiglu"            # 'swiglu' | 'relu2' (nemotron)

    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                  # routed-expert FFN width
    moe_layer_start: int = 0           # leading dense layers (deepseek: 3)
    moe_every: int = 1                 # MoE every n-th layer (jamba: 2)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # MLA (DeepSeek-V3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # SSM (Mamba2 SSD)
    layer_pattern: str = "attn"        # 'attn' | 'ssm' | 'jamba'
    attn_every: int = 8                # jamba: one attn layer per group of 8
    d_state: int = 0
    ssm_head_dim: int = 64
    d_conv: int = 4
    expand: int = 2
    ssd_chunk: int = 256

    # extras
    mtp_depth: int = 0                 # DeepSeek multi-token prediction heads
    tie_embeddings: bool = False
    modality: str = "text"             # 'text' | 'audio' | 'vision'
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # substrate
    optimizer: str = "adamw"           # 'adamw' | 'adafactor'
    remat: bool = True
    scan_layers: bool = True
    fsdp: bool = False                 # shard params over the data axis too

    # perf knobs (§Perf hillclimbing; defaults = paper-faithful baseline)
    flash_threshold: int = 8192        # KV length that triggers flash path
    flash_chunk: int = 2048            # flash KV chunk size
    moe_dp: int = 0                    # >0: two-stage local MoE dispatch
                                       # over this many data shards
    use_pallas_attention: bool = False  # kept for parity with the
                                        # reference; selects nothing here:
                                        # the flash path always runs the
                                        # CUDA kernel on a CUDA tensor
    mla_absorbed_decode: bool = False   # MLA: absorb W_uk/W_uv into q/out
                                        # and attend in latent space (the
                                        # DeepSeek serving optimization)
    replicate_misaligned_heads: bool = False  # data-only sharding for
                                        # attention mats whose head counts
                                        # don't divide the model axis

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_attn_layer(self, i: int) -> bool:
        if self.layer_pattern == "attn":
            return True
        if self.layer_pattern == "ssm":
            return False
        # jamba: one attention layer per group of `attn_every`
        return i % self.attn_every == self.attn_every // 2

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        return i >= self.moe_layer_start and (i % self.moe_every == 0)

    @property
    def has_decode(self) -> bool:
        return self.causal

    @property
    def subquadratic(self) -> bool:
        """Supports the long_500k shape: SSM/hybrid or sliding-window."""
        return self.layer_pattern in ("ssm", "jamba") or self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline accounting)."""
        d, hd = self.d_model, self.head_dim
        total = self.vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab * d
        for i in range(self.n_layers):
            total += 2 * d  # norms
            if self.is_attn_layer(i):
                if self.attn_type == "mla":
                    qr = self.q_lora_rank or d
                    total += d * qr + qr * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    total += d * (self.kv_lora_rank + self.qk_rope_dim)
                    total += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                    total += self.n_heads * self.v_head_dim * d
                else:
                    total += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                    total += self.n_heads * hd * d
                    if self.qkv_bias:
                        total += (self.n_heads + 2 * self.n_kv_heads) * hd
            else:  # mamba2 mixer
                di, ns, nh = self.d_inner, self.d_state, self.ssm_heads
                conv_ch = di + 2 * ns
                total += d * (2 * di + 2 * ns + nh)  # in_proj
                total += conv_ch * self.d_conv + conv_ch
                total += 2 * nh + di  # A, D(+dt_bias) per head, skip
                total += di * d  # out_proj
            n_mats = 3 if self.ffn_act == "swiglu" else 2
            if self.is_moe_layer(i):
                e_ff = self.moe_d_ff or self.d_ff
                total += d * self.n_experts  # router
                total += self.n_experts * 3 * d * e_ff
                total += self.n_shared_experts * 3 * d * e_ff
            else:
                total += n_mats * d * self.d_ff
        if self.mtp_depth:  # shared-embedding MTP head: proj + one block
            total += 2 * d * d + 3 * d * self.d_ff + 3 * d
            if self.attn_type == "mla":
                qr = self.q_lora_rank or d
                total += d * qr + qr * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                total += d * (self.kv_lora_rank + self.qk_rope_dim)
                total += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                total += self.n_heads * self.v_head_dim * d
        return total

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: only routed-to experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        e_ff = self.moe_d_ff or self.d_ff
        inactive_per_moe_layer = (
            (self.n_experts - self.experts_per_token) * 3 * d * e_ff
        )
        n_moe = sum(self.is_moe_layer(i) for i in range(self.n_layers))
        return self.param_count() - n_moe * inactive_per_moe_layer
