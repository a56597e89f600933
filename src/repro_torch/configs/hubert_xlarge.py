"""hubert-xlarge [audio] — encoder-only (arXiv:2106.07447).

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (masked-prediction cluster
targets).  The waveform/conv frontend is a STUB: input_specs() provides
precomputed frame embeddings (B, S, d_model).  Bidirectional attention,
no decode shapes.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    pos_emb="none",
    modality="audio",
    fsdp=True,
)

SMOKE = ModelConfig(
    name="hubert-xlarge-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=64,
    causal=False, pos_emb="none", modality="audio",
)
