"""Model zoo of the port (port of `repro.models`): the dense GQA decoder
stack; MLA, MoE and SSM stacks are still to port (ROADMAP A10)."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (LM, ForwardResult, forward, init_cache,
                                      init_params, unit_spec)

__all__ = ["LM", "ForwardResult", "ModelConfig", "forward", "init_cache",
           "init_params", "unit_spec"]
