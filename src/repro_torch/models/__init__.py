"""Model zoo of the port (port of `repro.models`): dense GQA, MLA, MoE,
Mamba2 SSD and the jamba hybrid, for all ten architectures of
`repro_torch.configs`."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (LM, ForwardResult, forward, init_cache,
                                      init_params, unit_spec)

__all__ = ["LM", "ForwardResult", "ModelConfig", "forward", "init_cache",
           "init_params", "unit_spec"]
