"""Serving engine (port of `repro.serve.engine`): prefill and decode
through the KV cache, greedy or temperature generation, and continuous
batching over a fixed batch of slots.

PyTorch runs eagerly, so `make_prefill` / `make_decode_step` return plain
functions where the reference returns jittable ones, and the decode loop
of `generate` is a Python loop where the reference scans.  The cache is
written in place.  Temperature sampling is the Gumbel-max draw that
`jax.random.categorical` makes, from uniforms the caller passes or draws
from a `torch.Generator`.

Under a mesh context (`sharding.ctx`) the engine is the rank's: its `data`
slice of the batch, its blocks of the weights (`convert.lm_params_block`),
its cache (build the engine inside the context: `init_cache` sizes the
rank's kv heads), and vocab-sharded logits, from which the next token is
chosen over the shards (`argmax_tokens`, told by `models.model.vocab_lo`
whether they are).  Every rank steps in lockstep.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.models import forward, init_cache, unit_spec
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig


def argmax_tokens(logits: torch.Tensor, *, vocab_lo: int | None) -> torch.Tensor:
    """(..., V) logits -> (...,) int64 argmax ids, ties to the lowest id as
    `torch.argmax`.  `vocab_lo` (`models.model.vocab_lo`, required) None:
    whole logits; else they are the rank's vocab columns from that id:
    each rank's (max, argmax), one all-gather over `model` of the pairs
    (float64, ids exact), the first maximum in rank order, so the lowest
    global id."""
    if vocab_lo is None:
        return torch.argmax(logits, dim=-1)
    from repro_torch.core.distributed import all_gather
    from repro_torch.sharding import ctx as mesh_ctx

    mx, idx = torch.max(logits, dim=-1)
    pair = torch.stack([mx.double(), (idx + vocab_lo).double()], dim=-1)
    every = all_gather(pair, mesh_ctx.current().mesh, "model", "sample")  # (n, ..., 2)
    best = torch.argmax(every[..., 0], dim=0, keepdim=True)
    return torch.gather(every[..., 1], 0, best)[0].long()


def _sample(logits: torch.Tensor, temperature: float, uniforms=None,
            generator: torch.Generator | None = None, *,
            vocab_lo: int | None) -> torch.Tensor:
    """(B, V) float32 logits -> (B,) int64 tokens: argmax when greedy,
    else argmax(logits / temperature + Gumbel noise) (categorical draw).
    Over vocab shards (`vocab_lo` not None) the uniforms are the global
    (B, vocab) draw sliced to the rank's ids, so sharded and whole engines
    pick the same tokens."""
    if temperature <= 0 or (uniforms is None and generator is None):
        return argmax_tokens(logits, vocab_lo=vocab_lo)
    width = logits.shape[-1]
    if uniforms is None:
        from repro_torch.sharding import tp

        vocab = width if vocab_lo is None else width * tp.size(tp.MODEL)
        uniforms = torch.rand(logits.shape[:-1] + (vocab,), generator=generator,
                              device=generator.device).to(logits.device)
    if vocab_lo is not None and uniforms.shape[-1] != width:
        uniforms = uniforms[..., vocab_lo:vocab_lo + width]
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(uniforms, tiny, 1.0)))
    return argmax_tokens(logits / temperature + gumbel, vocab_lo=vocab_lo)


def make_prefill(cfg: ModelConfig, s_max: int) -> Callable:
    def prefill(params, batch: dict, cache):
        kw = {k: batch[k] for k in ("tokens", "embeds", "positions3") if k in batch}
        out = forward(params, cfg, cache=cache, cache_len=0, **kw)
        return out.logits, out.cache

    return prefill


def make_decode_step(cfg: ModelConfig, temperature: float = 0.0) -> Callable:
    def decode_step(params, cache, last_tokens, cache_len: int, uniforms=None,
                    generator=None, positions3=None):
        """last_tokens: (B, 1) -> (next (B, 1) int32, logits (B, V), cache)."""
        out = forward(params, cfg, tokens=last_tokens, cache=cache,
                      cache_len=int(cache_len), positions3=positions3)
        logits = out.logits[:, -1]
        nxt = _sample(logits, temperature, uniforms, generator,
                      vocab_lo=model_lib.vocab_lo(params, cfg))
        return nxt[:, None].to(torch.int32), logits, out.cache

    return decode_step


def generate(params, cfg: ModelConfig, prompt: torch.Tensor, steps: int,
             s_max: Optional[int] = None, temperature: float = 0.0,
             seed: int = 0, uniforms=None) -> torch.Tensor:
    """Greedy / temperature generation: prefill + `steps - 1` decode steps.

    prompt (B, S) integer on the model's device.  Returns (B, steps) int32:
    the prefill's argmax token, then the decoded ones.  Temperature draws
    take `uniforms` (steps - 1, B, vocab) when given, else a generator on
    the prompt's device seeded with `seed`."""
    b, s = prompt.shape
    s_max = s_max or (s + steps)
    cache = init_cache(cfg, b, s_max, device=prompt.device)
    logits, cache = make_prefill(cfg, s_max)(params, {"tokens": prompt}, cache)
    last = argmax_tokens(logits[:, -1], vocab_lo=model_lib.vocab_lo(params, cfg))
    last = last[:, None].to(torch.int32)
    del logits  # (B, S, vocab) float32: free it before decoding
    if steps <= 1:
        return last
    decode = make_decode_step(cfg, temperature)
    gen = None
    if temperature > 0 and uniforms is None:
        gen = torch.Generator(device=prompt.device).manual_seed(seed)
    out = [last]
    for i in range(steps - 1):
        last, _, cache = decode(params, cache, last, s + i,
                                None if uniforms is None else uniforms[i], gen)
        out.append(last)
    return torch.cat(out, dim=1)


@dataclasses.dataclass
class Slot:
    active: bool = False
    request_id: int = -1
    cache_len: int = 0
    budget: int = 0
    tokens: list = dataclasses.field(default_factory=list)


class ServeEngine:
    """Continuous batching over B fixed slots, with the reference's
    behaviour: a batch-1 prefill a request, copied into the batch cache as
    the reference copies it (see `_admit`), and one shared cache_len
    frontier a decode call."""

    def __init__(self, params, cfg: ModelConfig, batch: int, s_max: int,
                 temperature: float = 0.0, wrap: Optional[Callable] = None):
        """`wrap(name, fn)`, when given, returns the function the engine
        calls in place of its "prefill" and "decode" step functions (a
        timer or a counter around them); the engine's behaviour is the
        same either way."""
        self.params, self.cfg = params, cfg
        self.batch, self.s_max = batch, s_max
        self.device = params.embed.device
        self.cache = init_cache(cfg, batch, s_max, device=self.device)
        self.slots = [Slot() for _ in range(batch)]
        self.queue: list[tuple[int, torch.Tensor, int]] = []
        self.done: dict[int, list[int]] = {}
        self._prefill1 = make_prefill(cfg, s_max)
        # the reference passes no key to its decode step: greedy always
        self._decode = make_decode_step(cfg, temperature)
        if wrap is not None:
            self._prefill1 = wrap("prefill", self._prefill1)
            self._decode = wrap("decode", self._decode)
        self._last = torch.zeros((batch, 1), dtype=torch.int32, device=self.device)
        self._n_prefix = unit_spec(cfg).n_prefix

    def submit(self, request_id: int, prompt: torch.Tensor, max_tokens: int):
        self.queue.append((request_id, prompt, max_tokens))

    def _admit(self) -> int:
        """Refill free slots FIFO from the submit queue; a slot freed by a
        finished request is reused for the next queued one on the following
        `step`.  Returns how many requests were admitted this call."""
        admitted = 0
        for i, slot in enumerate(self.slots):
            if slot.active or not self.queue:
                continue
            rid, prompt, budget = self.queue.pop(0)
            # single-slot prefill, then the cache row goes into the batch
            cache1 = init_cache(self.cfg, 1, self.s_max, device=self.device)
            logits, cache1 = self._prefill1(
                self.params, {"tokens": prompt.to(self.device)[None]}, cache1)
            nxt = int(argmax_tokens(logits[0, -1],
                                    vocab_lo=model_lib.vocab_lo(self.params, self.cfg)))
            del logits  # (1, S, vocab) float32
            # The reference writes the row with dynamic_update_slice_in_dim
            # at index i on axis 0 of each cache leaf.  A body leaf is
            # stacked over the units, (n_units, B, ...): axis 0 is the unit
            # axis, whose start clamps to 0, so the prefill lands in batch
            # row 0 and the other rows keep what decode wrote there.  A
            # prefix leaf (deepseek-v3's unrolled dense layers) is (B, ...):
            # the prefill lands in row i, the slot's own.  Kept for parity,
            # layer by layer and for every cache kind (ROADMAP C2).
            for li, (full, one) in enumerate(zip(self.cache, cache1)):
                row = i if li < self._n_prefix else 0
                for name, leaf in full.items():
                    leaf[row:row + 1].copy_(one[name])
            del cache1
            self._last[i, 0] = nxt
            self.slots[i] = Slot(active=True, request_id=rid,
                                 cache_len=prompt.shape[0], budget=budget,
                                 tokens=[nxt])
            admitted += 1
        return admitted

    def step(self) -> bool:
        """One decode step for every active slot."""
        self._admit()
        if not any(s.active for s in self.slots):
            return False
        # slots share one cache_len frontier a decode call, as in the
        # reference (per-slot lengths only set where a prefill wrote)
        pos = int(max(s.cache_len for s in self.slots if s.active))
        nxt, _, self.cache = self._decode(self.params, self.cache, self._last, pos)
        self._last = nxt
        toks = nxt[:, 0].tolist()
        for i, slot in enumerate(self.slots):
            if not slot.active:
                continue
            slot.tokens.append(toks[i])
            slot.cache_len += 1
            slot.budget -= 1
            if slot.budget <= 0:
                self.done[slot.request_id] = slot.tokens
                self.slots[i] = Slot()
        return True
