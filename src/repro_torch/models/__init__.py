"""Model zoo of the port (port of `repro.models`): dense GQA, MLA, MoE,
Mamba2 SSD and the jamba hybrid, for all ten architectures of
`repro_torch.configs`."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (LM, ForwardResult, cross_entropy, forward,
                                      init_cache, init_params, mtp_loss, unit_spec)

__all__ = ["LM", "ForwardResult", "ModelConfig", "cross_entropy", "forward",
           "init_cache", "init_params", "mtp_loss", "unit_spec"]
