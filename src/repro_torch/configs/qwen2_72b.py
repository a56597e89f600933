"""qwen2-72b [dense] — GQA with QKV bias (arXiv:2407.10671).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
Adafactor: fp32-Adam state for 72B exceeds the per-chip HBM budget
(DESIGN.md §4).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    fsdp=True,
    optimizer="adafactor",
)

SMOKE = ModelConfig(
    name="qwen2-72b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    qkv_bias=True, optimizer="adafactor",
)
