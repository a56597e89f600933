"""Training step (port of `repro.train.train_step`): loss, gradient
accumulation over microbatches, clipping, optimizer.

Loss = next-token cross-entropy (text / vision) or masked cluster
prediction (the audio encoder) + router_aux_coef x the routers' load
balance aux + 0.1 x the MTP loss (deepseek-v3).

`make_train_step(cfg, opt_cfg, accum)` returns a `TrainStep`,
    (model, opt_state, batch, step) -> (model, opt_state, metrics),
which updates the model's parameters in place.  Under a mesh context
(`sharding.ctx`) the model is the rank's blocks (`convert.lm_params_block`)
and the batch its `data` slice: the loss is the global batch's, each
gradient is summed over the batch axes that do not shard its parameter
(`sync_grads`), and the norm and the optimizer reduce over the axes that
shard each block, so every rank's block takes the unsharded update.  With accum > 1 the batch
is split into `accum` microbatches run one after the other (positions3
on its axis 1); their gradients are summed in float32 and scaled by
1 / accum, as the reference's scan does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.models import cross_entropy, forward, init_params, mtp_loss
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM, vocab_lo
from repro_torch.sharding import ctx as mesh_ctx
from repro_torch.sharding import tp
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.batching import forward_kwargs


class TrainMetrics(NamedTuple):
    loss: torch.Tensor
    ce_loss: torch.Tensor
    aux_loss: torch.Tensor
    grad_norm: torch.Tensor


def loss_fn(model: LM, cfg: ModelConfig, batch: dict):
    """(total, (ce, aux_loss)) of one batch through the training forward,
    the reference's formula (aux_loss unscaled, as it returns it)."""
    out = forward(model, cfg, train=True, **forward_kwargs(cfg, batch))
    zero = torch.zeros((), device=out.logits.device)
    lo = vocab_lo(model, cfg)
    if cfg.causal:
        if "labels" in batch:
            labels, mask = batch["labels"], batch.get("loss_mask")
            logits = out.logits
        else:
            logits = out.logits[:, :-1]
            labels = batch["tokens"][:, 1:]
            mask = None
        ce = cross_entropy(logits, labels, mask, vocab_lo=lo)
        extra = zero
        if cfg.mtp_depth and "tokens" in batch:
            toks = batch["tokens"]
            b, s = toks.shape
            pos = torch.arange(s, device=toks.device).expand(b, s)
            hid = out.hidden[:, -s:]
            extra = 0.1 * mtp_loss(model, cfg, hid, toks, pos)
    else:
        # encoder: masked prediction over all positions
        ce = cross_entropy(out.logits, batch["labels"], batch.get("loss_mask"), vocab_lo=lo)
        extra = zero
    aux = cfg.router_aux_coef * out.aux_loss
    total = ce + aux + extra
    return total, (ce, out.aux_loss)


def split_batch(batch: dict, accum: int, i: int) -> dict:
    """Microbatch i of `accum`: rows [i mb, (i + 1) mb) of every input
    (positions3 (3, B, S) on its axis 1)."""
    out = {}
    for name, x in batch.items():
        axis = 1 if name == "positions3" else 0
        mb = x.shape[axis] // accum
        out[name] = x.narrow(axis, i * mb, mb)
    return out


class TrainStep:
    """One optimizer step: gradients of `loss_fn` (accumulated over `accum`
    microbatches), clipped by global norm, then `apply_opt`.  `grads`
    keeps the last step's gradients (name -> tensor, before clipping) for
    inspection."""

    def __init__(self, cfg: ModelConfig, opt_cfg: opt_lib.OptConfig, accum: int = 1):
        if accum < 1:
            raise ValueError(f"accum must be >= 1, got {accum}")
        self.cfg, self.opt_cfg, self.accum = cfg, opt_cfg, accum
        self.grads: dict | None = None

    def _grads(self, model: LM, batch: dict, params: dict):
        total, (ce, aux) = loss_fn(model, self.cfg, batch)
        gs = torch.autograd.grad(total, list(params.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), gs)}
        return total.detach(), ce.detach(), aux.detach(), grads

    def compute_grads(self, model: LM, batch: dict):
        """(total, ce, aux, grads): the batch's losses and gradients by
        parameter name (a parameter the loss does not reach gets zeros)."""
        params = dict(model.named_parameters())
        self.grads = None  # free the last step's before this one's
        if self.accum == 1:
            return self._grads(model, batch, params)
        acc = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        sums = [torch.zeros((), device=next(iter(params.values())).device)
                for _ in range(3)]
        for i in range(self.accum):
            parts = self._grads(model, split_batch(batch, self.accum, i), params)
            for n, g in parts[3].items():
                acc[n].add_(g)
            for s, v in zip(sums, parts[:3]):
                s.add_(v)
            del parts
        inv = 1.0 / self.accum
        for g in acc.values():
            g.mul_(inv)
        return sums[0] * inv, sums[1] * inv, sums[2] * inv, acc

    def _groups(self, params: dict) -> dict:
        names = tuple(params)
        if getattr(self, "_groups_for", None) != names:
            self._groups_for, self._groups_cache = names, opt_lib.param_groups(self.cfg, params)
        return self._groups_cache

    def __call__(self, model: LM, opt_state: dict, batch: dict, step: int):
        total, ce, aux, grads = self.compute_grads(model, batch)
        params = {n: p for n, p in model.named_parameters()}
        ctx = mesh_ctx.current()
        specs = None
        if ctx is not None:
            specs = {n: tp.spec_of(p) for n, p in params.items()}
            grads = sync_grads(grads, specs, ctx)
        self.grads = grads
        clipped, gnorm = opt_lib.clip_by_global_norm(grads, self.opt_cfg.grad_clip, specs)
        _, opt_state = opt_lib.apply_opt(self.cfg.optimizer, clipped, opt_state, params,
                                         self.opt_cfg, self._groups(params), specs)
        return model, opt_state, TrainMetrics(loss=total, ce_loss=ce, aux_loss=aux,
                                               grad_norm=gnorm)


def sync_grads(grads: dict, specs: dict, ctx) -> dict:
    """Each gradient summed over the batch axes that do not shard its
    parameter (one counted all-reduce an axis and parameter, site
    "grad_sync"): a rank's gradient is its data slice's share (the loss
    is the global batch's mean), and a parameter sharded over `data`
    (fsdp) had its share summed by the gather's reduce-scatter."""
    out = {}
    for name, g in grads.items():
        sharded = {a for e in specs[name] for a in tp.axes_of(e)}
        out[name] = tp.total(g, [a for a in ctx.batch_axes if a not in sharded],
                             "grad_sync")
    return out


def make_train_step(cfg: ModelConfig, opt_cfg: opt_lib.OptConfig,
                    accum: int = 1) -> TrainStep:
    return TrainStep(cfg, opt_cfg, accum)


def init_train_state(cfg: ModelConfig, seed: int = 0, device=None):
    """(model with trainable parameters drawn from `seed`, optimizer state
    of cfg.optimizer) on `device` (the card unless "cpu")."""
    device = resolve_device(device)
    model = init_params(cfg, seed=seed, device=device).train_mode()
    params = dict(model.named_parameters())
    opt_state = opt_lib.init_opt(cfg.optimizer, params, opt_lib.param_groups(cfg, params))
    return model, opt_state
