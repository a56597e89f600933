"""yi-6b [dense] — llama-arch GQA (arXiv:2403.04652).

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    rope_theta=5e6,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="yi-6b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=96, vocab=512,
)
