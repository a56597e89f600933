"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution (arXiv:2409.12191).

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.  The vision tower
is a STUB: input_specs() provides precomputed patch embeddings (B, P,
d_model) as a prefix plus 3-D (t/h/w) M-RoPE position ids for the full
sequence.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    qkv_bias=True,
    pos_emb="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    modality="vision",
    fsdp=True,
)

SMOKE = ModelConfig(
    name="qwen2-vl-7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    qkv_bias=True, pos_emb="mrope", mrope_sections=(2, 3, 3),
    modality="vision",
)
