"""Optimizers (port of `repro.train.optimizer`): AdamW and Adafactor, as
plain tensor functions over a name -> tensor dict of parameters.

AdamW keeps float32 master weights and two float32 moments (12 bytes a
parameter); Adafactor a factored second moment (row and column vectors for
parameters of two or more dims) and no momentum.  The updates run under
no_grad and write in place (the parameters, the master weights and the
moments): at qwen1.5-0.5b's 0.46B parameters a functional update would
hold a second copy of the 5.6 GB AdamW state.  Each element's arithmetic
is the reference's, in its order, in float32.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # adafactor
    decay: float = 0.8
    clip_threshold: float = 1.0


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------

def global_norm(tensors: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x^2), each in float32."""
    leaves = [torch.sum(torch.square(x.float())) for x in tensors.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), norm): new tensors, the
    scale cast to each gradient's dtype as in the reference."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

def adamw_init(params: dict) -> dict:
    """{"master", "m", "v"}: name -> float32 tensor each (master a copy of
    the parameter), and "count" (int32, 0)."""
    dev = next(iter(params.values())).device
    return {
        "master": {n: p.detach().float().clone() for n, p in params.items()},
        "m": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
        "v": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def adamw_update(grads: dict, state: dict, params: dict, cfg: OptConfig):
    count = state["count"] + 1
    cf = count.float()
    b1c = 1.0 - _f32(cfg.b1, cf) ** cf
    b2c = 1.0 - _f32(cfg.b2, cf) ** cf
    for name, g in grads.items():
        g = g.float()
        m, v, master = state["m"][name], state["v"][name], state["master"][name]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        step = step + cfg.weight_decay * master
        master.sub_(cfg.lr * step)
        params[name].copy_(master)
    state["count"] = count
    return params, state


# --------------------------------------------------------------------------
# Adafactor (factored second moments, momentum-free)
# --------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor_init(params: dict) -> dict:
    """{"v": name -> {"vr" (rows), "vc" (columns)} for a parameter of two
    or more dims, else {"v"}; "count" (int32, 0)}, float32 zeros."""
    def init(p):
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                      device=p.device)}
        return {"v": torch.zeros_like(p, dtype=torch.float32)}

    dev = next(iter(params.values())).device
    return {"v": {n: init(p) for n, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adafactor_update(grads: dict, state: dict, params: dict, cfg: OptConfig):
    count = state["count"] + 1
    beta = 1.0 - count.float() ** (-cfg.decay)
    for name, g in grads.items():
        g = g.float()
        p, v = params[name], state["v"][name]
        g2 = g * g + 1e-30
        if _factored(g.shape):
            v["vr"].copy_(beta * v["vr"] + (1 - beta) * torch.mean(g2, dim=-1))
            v["vc"].copy_(beta * v["vc"] + (1 - beta) * torch.mean(g2, dim=-2))
            denom = torch.clamp_min(torch.mean(v["vr"], dim=-1, keepdim=True), 1e-30)
            vhat = (v["vr"][..., None] * v["vc"][..., None, :]) / denom[..., None]
        else:
            v["v"].copy_(beta * v["v"] + (1 - beta) * g2)
            vhat = v["v"]
        update = g / torch.sqrt(vhat + 1e-30)
        # update clipping (Shazeer & Stern)
        rms = torch.sqrt(torch.mean(update * update) + 1e-30)
        update = update / torch.clamp_min(rms / cfg.clip_threshold, 1.0)
        update = update + cfg.weight_decay * p.float()
        p.copy_(p.float() - cfg.lr * update)
    state["count"] = count
    return params, state


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

def init_opt(name: str, params: dict) -> dict:
    return adamw_init(params) if name == "adamw" else adafactor_init(params)


def apply_opt(name: str, grads: dict, state: dict, params: dict, cfg: OptConfig):
    """One update of `params` (name -> tensor, written in place) from
    `grads`; returns (params, state), both updated in place."""
    if name == "adamw":
        return adamw_update(grads, state, params, cfg)
    return adafactor_update(grads, state, params, cfg)
