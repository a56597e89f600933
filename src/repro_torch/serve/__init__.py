"""Serving substrate of the port (port of `repro.serve`): the prefill /
decode engine with its KV cache and continuous batching, and the AÇAI
semantic cache tier in front of generation.  The answer cache, the
remote and resilience tiers and the online queue are ROADMAP A9."""

from repro_torch.serve.engine import (ServeEngine, Slot, generate,
                                      make_decode_step, make_prefill)
from repro_torch.serve.semantic_cache import (SemanticCachedLM, ServeStats,
                                              embed_prompt)

__all__ = ["SemanticCachedLM", "ServeEngine", "ServeStats", "Slot",
           "embed_prompt", "generate", "make_decode_step", "make_prefill"]
