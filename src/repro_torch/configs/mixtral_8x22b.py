"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention
(arXiv:2401.04088).

56L d_model=6144 48H (GQA kv=8) expert d_ff=16384 vocab=32768.
SWA window 4096 -> sub-quadratic: long_500k decode runs with a
window-bounded ring-buffer KV cache.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    n_experts=8,
    experts_per_token=2,
    moe_d_ff=16384,
    sliding_window=4096,
    rope_theta=1e6,
    fsdp=True,
    optimizer="adafactor",
)

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    n_experts=4, experts_per_token=2, moe_d_ff=128, sliding_window=32,
    capacity_factor=0.0,  # dropless for exact decode-consistency tests
    optimizer="adafactor",
)
