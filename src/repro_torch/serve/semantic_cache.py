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

The policy is one config knob (`policy_spec`): AÇAI by default, or any
registered baseline (`sim_lru`, `qcache`, ...), which serves through an
online `ServerOracle` (exact kNN a mini-batch, on the `l2_topk` kernel on
the card).  Every policy speaks the `CachePolicy` step contract, catalog
mutation included (`add_documents`, `remove_documents`, `compact`).

`answer_cache` fronts AÇAI's index with the exact answer memo
(`repro_torch.serve.answer_cache`); `remote` / `resilience` route every
request through the resilient remote tier (`ResilientPolicy`: retries,
hedging, deadline, circuit breaker, degradation), for any policy.  The
mesh (ROADMAP A11) raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import policy_api
from repro_torch.core.costs import CostModel, calibrate_fetch_cost
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
    """A similarity cache wrapping a generate() callable.  It runs on the
    device of `params` (the model)."""

    def __init__(self, params, cfg: ModelConfig, catalog_embs,
                 catalog_payloads: list, generate_fn: Callable,
                 h: int = 64, k: int = 4, c_f: Optional[float] = None,
                 eta: Optional[float] = None, seed: int = 0, mesh=None,
                 index_spec=None, policy_spec=None, remote=None,
                 resilience=None, answer_cache=None):
        if mesh is not None:
            raise NotImplementedError(_NOT_PORTED.format(
                what="the sharded semantic tier (mesh)", item=11))
        self.params, self.cfg = params, cfg
        self.device = params.embed.device
        self.payloads = list(catalog_payloads)
        self.generate_fn = generate_fn
        catalog = torch.as_tensor(catalog_embs, dtype=torch.float32).to(
            self.device).contiguous()
        if c_f is None:
            c_f = calibrate_fetch_cost(catalog, kth=min(50, len(self.payloads) - 1),
                                       device=self.device)
        index_spec = resolve_spec(index_spec)
        # policy_spec: a PolicySpec, its flat dict or a name; None = AÇAI.
        # The h / k / eta arguments are defaults, spec params win
        spec = policy_api.resolve_policy_spec(policy_spec)
        if spec is None:
            spec = policy_api.PolicySpec("acai")
        base = {"h": h, "k": k}
        if spec.name == "acai":
            # candidate widths follow the effective k (a spec k wins)
            k_eff = int(spec.params.get("k", k))
            base.update(c_remote=max(4 * k_eff, 16), c_local=max(k_eff, 8))
            if eta is not None:
                base["eta"] = eta
        elif eta is not None:
            raise ValueError(f"eta only applies to the 'acai' policy, not "
                             f"{spec.name!r}")
        spec = policy_api.PolicySpec(spec.name, {**base, **spec.params})
        if spec.name != "acai" and (index_spec is not None
                                    or answer_cache is not None):
            raise ValueError(
                f"policy {spec.name!r} serves from the exact server oracle; "
                f"index_spec/mesh/answer_cache only apply to 'acai'")
        self.policy = policy_api.build_policy(
            spec, catalog, CostModel(c_f=float(c_f)), index_spec=index_spec,
            seed=seed, answer_cache=answer_cache, device=self.device)
        # resilient serving: with a remote backend and / or a resilience
        # config, every request first runs its remote interaction, and
        # failures fall down the degradation ladder, for any policy
        if remote is not None or resilience is not None:
            from repro_torch.serve.resilience import ResilientPolicy

            self.policy = ResilientPolicy(self.policy, remote, resilience)
        # the underlying AcaiCache (None for baselines)
        self.cache = getattr(getattr(self.policy, "inner", self.policy), "cache", None)
        self.stats = ServeStats()

    @property
    def k(self) -> int:
        return self.policy.k

    @property
    def policy_spec(self):
        return self.policy.spec

    @property
    def answer_cache(self):
        """The answer tier's `CachedIndex` (None when off): `.stats()`
        carries the hit, invalidation and unload counts."""
        return getattr(getattr(self.policy, "inner", self.policy), "answer_cache", None)

    def query(self, prompt_tokens: torch.Tensor, u=None):
        """Serve one prompt (S,): the k most similar cached results, each
        local or remote; a request not served wholly from the store runs
        generation.  `u` optionally injects the step's rounding uniforms
        (AÇAI only)."""
        r = embed_prompt(self.params, prompt_tokens.to(self.device))
        m = self.policy.serve_update(r) if u is None else self.policy.serve_update(r, u=u)
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
        m = (self.policy.serve_update_batch(rs) if u is None
             else self.policy.serve_update_batch(rs, u=u))
        served = m.served_local.tolist()
        self.stats.requests += len(prompts)
        self.stats.served_local += int(sum(served))
        self.stats.total_gain += float(torch.sum(m.gain_int))
        for p, s in zip(prompts, served):
            if s < self.k:
                self.stats.generated += 1
                _ = self.generate_fn(p)
        return m

    # -- online catalog mutation ----------------------------------------------

    def add_documents(self, embeddings, payloads) -> list:
        """Admit freshly computed results online: the policy's catalog (and
        its index) learns the embeddings, the payload table grows with
        them.  Returns the documents' ids (stable until a `compact`)."""
        embeddings = torch.atleast_2d(torch.as_tensor(embeddings, dtype=torch.float32))
        payloads = list(payloads)
        if len(payloads) != embeddings.shape[0]:
            raise ValueError(f"add_documents: {embeddings.shape[0]} embeddings but "
                             f"{len(payloads)} payloads")
        ids = [int(i) for i in self.policy.add_objects(embeddings.to(self.device))]
        # ids are never recycled: pad the table up to the high-water mark
        self.payloads.extend([None] * (max(ids) + 1 - len(self.payloads)))
        for i, p in zip(ids, payloads):
            self.payloads[i] = p
        return ids

    def remove_documents(self, ids) -> None:
        """Expire documents online: tombstoned in the policy (never served
        again, any cached copy dropped at once); their payload slots are
        cleared, not reused, until a `compact` renumbers the table."""
        self.policy.remove_objects(ids)
        for i in ids:
            self.payloads[int(i)] = None

    def compact(self) -> None:
        """Epoch compaction: the policy drops its tombstoned rows and
        renumbers the rest; the payload table follows the same remap (ids
        handed out before are invalidated)."""
        remap = self.policy.compact()
        new = [None] * int((remap >= 0).sum())
        for old_id, new_id in enumerate(remap):
            if new_id >= 0 and old_id < len(self.payloads):
                new[int(new_id)] = self.payloads[old_id]
        self.payloads = new

    @property
    def nag(self) -> float:
        return self.policy.normalized_gain(self.stats.total_gain, self.stats.requests)
