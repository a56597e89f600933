"""qwen1.5-0.5b [dense] — QKV bias (hf:Qwen/Qwen1.5-0.5B).

24L d_model=1024 16H (GQA kv=16, i.e. MHA) d_ff=2816 vocab=151936.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e4,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen1.5-0.5b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    qkv_bias=True, tie_embeddings=True,
)
