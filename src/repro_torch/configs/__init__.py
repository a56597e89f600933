"""Architecture registry of the port (port of `repro.configs`).

The dense GQA family is ported: qwen1.5-0.5b, yi-6b, minitron-8b and
qwen2-72b, each with its full CONFIG and a reduced SMOKE variant for CPU
tests.  The six other architectures of the reference need mixers or
frontends that are not ported yet (MLA, MoE, SSM, the jamba hybrid, the
VLM and audio frontends); `get_config` names ROADMAP A10 for them.
"""

from repro_torch.configs import minitron_8b, qwen1_5_0_5b, qwen2_72b, yi_6b
from repro_torch.configs.shapes import SHAPES, SMOKE_SHAPES, ShapeSpec, runnable

_MODULES = {
    "minitron-8b": minitron_8b,
    "yi-6b": yi_6b,
    "qwen2-72b": qwen2_72b,
    "qwen1.5-0.5b": qwen1_5_0_5b,
}

# the reference's other architectures, by the part the port still lacks
NOT_PORTED = {
    "mamba2-130m": "the Mamba2 SSM mixer",
    "hubert-xlarge": "the audio frontend (encoder)",
    "jamba-1.5-large-398b": "the jamba hybrid (SSM + MoE)",
    "qwen2-vl-7b": "the VLM frontend",
    "mixtral-8x22b": "the MoE FFN",
    "deepseek-v3-671b": "MLA and the MoE FFN",
}

ARCHS = {name: mod.CONFIG for name, mod in _MODULES.items()}
SMOKE_ARCHS = {name: mod.SMOKE for name, mod in _MODULES.items()}


def get_config(arch: str, smoke: bool = False):
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch} is not ported yet: it needs {NOT_PORTED[arch]} "
            f"(ROADMAP A10)")
    table = SMOKE_ARCHS if smoke else ARCHS
    if arch not in table:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(table)}")
    return table[arch]


__all__ = ["ARCHS", "NOT_PORTED", "SHAPES", "SMOKE_ARCHS", "SMOKE_SHAPES",
           "ShapeSpec", "get_config", "runnable"]
