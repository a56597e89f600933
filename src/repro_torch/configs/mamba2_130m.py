"""mamba2-130m [ssm] — SSD, attention-free (arXiv:2405.21060).

24L d_model=768 (no attention, no FFN: pure mamba2 blocks) vocab=50280,
ssm_state=128.  expand=2 -> d_inner=1536, head_dim=64 -> 24 SSD heads.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    layer_pattern="ssm",
    d_state=128,
    ssm_head_dim=64,
    expand=2,
    d_conv=4,
    pos_emb="none",
    tie_embeddings=True,
    optimizer="adamw",
)

SMOKE = ModelConfig(
    name="mamba2-130m-smoke",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0, vocab=256,
    layer_pattern="ssm", d_state=16, ssm_head_dim=16, expand=2, d_conv=4,
    pos_emb="none", tie_embeddings=True, ssd_chunk=16,
)
