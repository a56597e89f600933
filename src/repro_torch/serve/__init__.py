"""Serving substrate of the port (port of `repro.serve`): the prefill /
decode engine with its KV cache and continuous batching, the AÇAI
semantic cache tier in front of generation, the resilient remote tier
(fault-injected backend, retries / hedging / deadlines / circuit breaker
and the degradation ladder), the online serving engine (arrival
processes, request queue, dynamic batch former and admission control on
the virtual clock) and the answer-cache tier (exact top-k memoization in
front of the index with precise churn invalidation and idle unload)."""

from repro_torch.serve.answer_cache import (AnswerCache, AnswerCacheSpec,
                                            CachedIndex, parse_answer_cache_opts,
                                            resolve_answer_cache_spec)
from repro_torch.serve.arrivals import (ARRIVAL_KINDS, ArrivalSpec,
                                        ClosedLoopSource, OpenLoopSource,
                                        arrival_times, make_source)
from repro_torch.serve.engine import (ServeEngine, Slot, generate,
                                      make_decode_step, make_prefill)
from repro_torch.serve.queue import (AdmissionConfig, BatchFormerConfig,
                                     OnlineServingEngine, RequestRecord,
                                     ServiceModel, fixed_window_engine,
                                     serve_trace_online)
from repro_torch.serve.remote import (FaultSpec, FaultyRemote, OracleRemote,
                                      RemoteBackend, parse_outage_windows,
                                      payload_ok)
from repro_torch.serve.resilience import (CircuitBreaker, RemoteSession,
                                          ResilienceConfig, ResilientPolicy,
                                          RetryConfig, replay_resilient,
                                          simulate_request)
from repro_torch.serve.semantic_cache import (SemanticCachedLM, ServeStats,
                                              embed_prompt)

__all__ = ["ARRIVAL_KINDS", "AdmissionConfig", "AnswerCache",
           "AnswerCacheSpec", "ArrivalSpec", "BatchFormerConfig", "CachedIndex",
           "CircuitBreaker", "ClosedLoopSource", "FaultSpec", "FaultyRemote",
           "OnlineServingEngine", "OpenLoopSource", "OracleRemote",
           "RemoteBackend", "RemoteSession", "RequestRecord", "ResilienceConfig",
           "ResilientPolicy", "RetryConfig", "SemanticCachedLM", "ServeEngine",
           "ServeStats", "ServiceModel", "Slot", "arrival_times", "embed_prompt",
           "fixed_window_engine", "generate", "make_decode_step", "make_prefill",
           "make_source", "parse_answer_cache_opts", "parse_outage_windows",
           "payload_ok", "replay_resilient", "resolve_answer_cache_spec",
           "serve_trace_online", "simulate_request"]
