"""minitron-8b [dense] — pruned nemotron (arXiv:2407.14679).

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
Squared-ReLU 2-matrix FFN (nemotron family) — with it the analytic count
lands on 8.2B, matching the advertised size.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab=256000,
    rope_theta=1e4,
    ffn_act="relu2",
    fsdp=True,
)

SMOKE = ModelConfig(
    name="minitron-8b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    ffn_act="relu2",
)
