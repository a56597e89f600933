"""Architecture registry of the port (port of `repro.configs`): the ten
architectures of the reference, each with its full CONFIG and a reduced
SMOKE variant for CPU tests, field for field the reference's.

The dense GQA family (qwen1.5-0.5b, yi-6b, minitron-8b, qwen2-72b), the
MoE models (mixtral-8x22b; deepseek-v3-671b with MLA), the Mamba2 SSM
(mamba2-130m), the jamba hybrid, and the models behind a stubbed
frontend (qwen2-vl-7b's patch embeddings, hubert-xlarge's audio frames).
"""

from repro_torch.configs import (deepseek_v3, hubert_xlarge, jamba_1_5_large,
                                 mamba2_130m, minitron_8b, mixtral_8x22b,
                                 qwen1_5_0_5b, qwen2_72b, qwen2_vl_7b, yi_6b)
from repro_torch.configs.shapes import SHAPES, SMOKE_SHAPES, ShapeSpec, runnable

_MODULES = {
    "mamba2-130m": mamba2_130m,
    "minitron-8b": minitron_8b,
    "yi-6b": yi_6b,
    "qwen2-72b": qwen2_72b,
    "qwen1.5-0.5b": qwen1_5_0_5b,
    "hubert-xlarge": hubert_xlarge,
    "jamba-1.5-large-398b": jamba_1_5_large,
    "qwen2-vl-7b": qwen2_vl_7b,
    "mixtral-8x22b": mixtral_8x22b,
    "deepseek-v3-671b": deepseek_v3,
}

ARCHS = {name: mod.CONFIG for name, mod in _MODULES.items()}
SMOKE_ARCHS = {name: mod.SMOKE for name, mod in _MODULES.items()}


def get_config(arch: str, smoke: bool = False):
    table = SMOKE_ARCHS if smoke else ARCHS
    if arch not in table:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(table)}")
    return table[arch]


__all__ = ["ARCHS", "SHAPES", "SMOKE_ARCHS", "SMOKE_SHAPES", "ShapeSpec",
           "get_config", "runnable"]
