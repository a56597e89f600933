"""deepseek-v3-671b [moe] — MLA + 1 shared + 256 routed top-8 + MTP
(arXiv:2412.19437).

61L d_model=7168 128H, MLA (q_lora 1536, kv_lora 512, rope 64, nope 128,
v 128), routed-expert d_ff=2048, 3 leading dense layers (d_ff=18432),
vocab=129280, MTP depth 1.  Adafactor: fp32-Adam state for 671B exceeds
the aggregate HBM of 512 v5e chips (DESIGN.md §4).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,             # leading dense layers
    vocab=129280,
    attn_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    n_experts=256,
    experts_per_token=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    moe_layer_start=3,
    capacity_factor=1.25,
    mtp_depth=1,
    fsdp=True,
    optimizer="adafactor",
)

SMOKE = ModelConfig(
    name="deepseek-v3-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    attn_type="mla", q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8,
    qk_nope_dim=16, v_head_dim=16, n_experts=4, experts_per_token=2,
    n_shared_experts=1, moe_d_ff=64, moe_layer_start=1, mtp_depth=1,
    capacity_factor=0.0,  # dropless for exact decode-consistency tests
    optimizer="adafactor",
)
