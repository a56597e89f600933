"""Semantic cache (port of `repro.serve.semantic_cache`): the AÇAI
similarity cache as the retrieval tier in front of LM inference.

The deployment the paper motivates: an edge server receives prompts,
embeds them, and runs a similarity search over a catalog of previously
computed results.  The policy decides per object whether to serve from
the local store (cost = dissimilarity) or to compute / fetch remotely
(cost = dissimilarity + c_f), and updates the local store; a request not
served wholly from the store runs generation.

`embed_prompt` derives the request embedding from the LM's own token
embedding table (mean pooled and normalised), so no extra encoder is
needed.

The port builds its `AcaiCache` directly, with the AcaiConfig that the
reference's `acai_config_from_spec` gives for PolicySpec("acai"): the
policy registry (ROADMAP A6), the baselines, the mesh (A11), the remote
and resilience tiers and the answer cache (A9) and catalog mutation (A8)
are not ported and raise NotImplementedError naming their item.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import oma as oma_lib
from repro_torch.core.costs import calibrate_fetch_cost
from repro_torch.core.policy import AcaiCache, AcaiConfig
from repro_torch.index.base import resolve_spec
from repro_torch.models.config import ModelConfig

_NOT_PORTED = "{what} is not ported yet (ROADMAP A{item})"


def embed_prompt(params, tokens: torch.Tensor) -> torch.Tensor:
    """(S,) integer tokens -> (d,) normalised mean-pooled float32 embedding;
    (B, S) -> (B, d), one row a prompt."""
    e = params.embed[tokens.long()].float()
    v = torch.mean(e, dim=-2)
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True), 1e-6)


@dataclasses.dataclass
class ServeStats:
    requests: int = 0
    served_local: int = 0
    generated: int = 0
    total_gain: float = 0.0


class SemanticCachedLM:
    """An AÇAI similarity cache wrapping a generate() callable.  It runs on
    the device of `params` (the model)."""

    def __init__(self, params, cfg: ModelConfig, catalog_embs,
                 catalog_payloads: list, generate_fn: Callable,
                 h: int = 64, k: int = 4, c_f: Optional[float] = None,
                 eta: Optional[float] = None, seed: int = 0, mesh=None,
                 index_spec=None, policy_spec=None, remote=None,
                 resilience=None, answer_cache=None):
        if policy_spec not in (None, "acai"):
            raise NotImplementedError(_NOT_PORTED.format(
                what=f"policy {policy_spec!r} (the policy registry and the "
                     f"baselines)", item=6))
        if mesh is not None:
            raise NotImplementedError(_NOT_PORTED.format(
                what="the sharded semantic tier (mesh)", item=11))
        if remote is not None or resilience is not None:
            raise NotImplementedError(_NOT_PORTED.format(
                what="resilient serving against a remote backend", item=9))
        if answer_cache is not None:
            raise NotImplementedError(_NOT_PORTED.format(
                what="the answer-cache tier", item=9))
        self.params, self.cfg = params, cfg
        self.device = params.embed.device
        self.payloads = list(catalog_payloads)
        self.generate_fn = generate_fn
        catalog = torch.as_tensor(catalog_embs, dtype=torch.float32).to(
            self.device).contiguous()
        if c_f is None:
            c_f = calibrate_fetch_cost(catalog, kth=min(50, len(self.payloads) - 1),
                                       device=self.device)
        c_f = float(c_f)
        acai = AcaiConfig(
            h=int(h), k=int(k), c_f=c_f, c_remote=max(4 * k, 16),
            c_local=max(k, 8),
            oma=oma_lib.OMAConfig(eta=float(eta) if eta is not None else 0.05 / c_f),
            index=resolve_spec(index_spec))
        self.cache = AcaiCache(catalog, acai, seed=seed, device=self.device)
        self.stats = ServeStats()

    @property
    def k(self) -> int:
        return self.cache.cfg.k

    def query(self, prompt_tokens: torch.Tensor, u=None):
        """Serve one prompt (S,): the k most similar cached results, each
        local or remote; a request not served wholly from the store runs
        generation.  `u` optionally injects the step's rounding uniforms."""
        r = embed_prompt(self.params, prompt_tokens.to(self.device))
        m = self.cache.serve_update(r, u)
        served = int(m.served_local)
        self.stats.requests += 1
        self.stats.served_local += served
        self.stats.total_gain += float(m.gain_int)
        if served < self.k:
            self.stats.generated += 1
            _ = self.generate_fn(prompt_tokens)
        return m

    def query_batch(self, prompts: list, u=None):
        """Serve a batch of prompts with one AÇAI mini-batch step, then run
        generation for each request not served wholly from the store.
        Returns StepMetrics with a (B,) leading axis."""
        if len({p.shape[0] for p in prompts}) == 1:
            rs = embed_prompt(self.params, torch.stack(prompts).to(self.device))
        else:
            rs = torch.stack([embed_prompt(self.params, p.to(self.device))
                              for p in prompts])
        m = self.cache.serve_update_batch(rs, u)
        served = m.served_local.tolist()
        self.stats.requests += len(prompts)
        self.stats.served_local += int(sum(served))
        self.stats.total_gain += float(torch.sum(m.gain_int))
        for p, s in zip(prompts, served):
            if s < self.k:
                self.stats.generated += 1
                _ = self.generate_fn(p)
        return m

    def _mutation(self, *_args, **_kw):
        raise NotImplementedError(_NOT_PORTED.format(
            what="online catalog mutation", item=8))

    add_documents = remove_documents = compact = _mutation

    @property
    def nag(self) -> float:
        return self.cache.normalized_gain(self.stats.total_gain, self.stats.requests)
