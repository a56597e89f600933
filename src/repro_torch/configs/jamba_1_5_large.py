"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7 interleave + MoE
(arXiv:2403.19887).

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16 experts
top-2 on every other layer.  Scan unit = 8 layers (attention at slot 4),
9 units.  Mamba mixer: d_state=64, d_inner=16384.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    layer_pattern="jamba",
    attn_every=8,
    d_state=64,
    ssm_head_dim=64,
    expand=2,
    n_experts=16,
    experts_per_token=2,
    moe_d_ff=24576,
    moe_every=2,
    pos_emb="none",  # jamba uses no positional encoding (mamba provides order)
    fsdp=True,
    optimizer="adafactor",
)

SMOKE = ModelConfig(
    name="jamba-1.5-large-smoke",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    layer_pattern="jamba", attn_every=8, d_state=16, ssm_head_dim=16,
    expand=2, n_experts=4, experts_per_token=2, moe_d_ff=128, moe_every=2,
    pos_emb="none", ssd_chunk=16, optimizer="adafactor",
    capacity_factor=0.0,  # dropless for exact decode-consistency tests
)
