"""AÇAI core of the port (port of `repro.core`), with the reference's
exports.

  costs       — dissimilarity / fetching cost model, augmented catalog
  gain        — service cost Eq. (5), caching gain Eq. (7), subgradient Eq. (55)
  mirror      — mirror maps (negative entropy / Euclidean)
  projection  — Bregman projections onto the capped simplex
  oma         — Online Mirror Ascent, Algorithm 1
  rounding    — DepRound + CoupledRounding
  policy      — AcaiCache: serving (Eq. 2) + state updates, trace replay
  policy_api  — CachePolicy protocol, PolicySpec, build_policy registry
  baselines   — LRU, SIM-LRU, CLS-LRU, RND-LRU, QCACHE
  trace       — synthetic traces + TraceSpec scenario registry
"""

from repro_torch.core.costs import CostModel, calibrate_fetch_cost, pairwise_dissimilarity
from repro_torch.core.gain import gain_and_subgradient, gain_value, serve
from repro_torch.core.oma import OMAConfig, oma_update, theoretical_eta, uniform_state
from repro_torch.core.policy import (AcaiCache, AcaiConfig, init_state, make_replay,
                                     make_replay_batched, make_step, make_step_batched)
from repro_torch.core.policy_api import (CachePolicy, PolicySpec, build_policy,
                                         parse_policy_opts, registered_policies)
from repro_torch.core.rounding import coupled_rounding, depround, independent_rounding
from repro_torch.core.trace import TraceSpec, build_trace, registered_traces

__all__ = [
    "AcaiCache",
    "AcaiConfig",
    "CachePolicy",
    "CostModel",
    "PolicySpec",
    "TraceSpec",
    "build_policy",
    "build_trace",
    "parse_policy_opts",
    "registered_policies",
    "registered_traces",
    "OMAConfig",
    "calibrate_fetch_cost",
    "coupled_rounding",
    "depround",
    "gain_and_subgradient",
    "gain_value",
    "independent_rounding",
    "init_state",
    "make_replay",
    "make_replay_batched",
    "make_step",
    "make_step_batched",
    "oma_update",
    "pairwise_dissimilarity",
    "serve",
    "theoretical_eta",
    "uniform_state",
]
