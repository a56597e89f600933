"""Optimizers (port of `repro.train.optimizer`): AdamW and Adafactor, as
plain tensor functions over a name -> tensor dict of parameters.

AdamW keeps float32 master weights and two float32 moments (12 bytes a
parameter); Adafactor a factored second moment (row and column vectors for
parameters of two or more dims) and no momentum.  The updates run under
no_grad and write in place (the parameters, the master weights and the
moments): at qwen1.5-0.5b's 0.46B parameters a functional update would
hold a second copy of the 5.6 GB AdamW state.  Each element's arithmetic
is the reference's, in its order, in float32.

Adafactor works on the reference's leaves (`param_groups`): the reference
stacks each body slot's parameter over the scanned units into one
(n_units, ...) leaf, and its factoring and update clipping see that leaf
whole.  A group is the port's layers at one body slot, in unit order, and
is updated as that stacked leaf: a 1-D parameter's group is factored into
vr (n_units,) and vc (d,), a matrix's keeps vr / vc a unit, stacked, and
the update's RMS is taken over every layer of the group.  Two passes over
a matrix group's layers (statistics and the RMS, then the update) keep
the stacked gradient from ever being built.  Prefix layers, `mtp` and the
top-level leaves are groups of one, unstacked.

Under a mesh context (`specs` name -> the parameter's partition spec),
every tensor is the rank's block: Adafactor's means, its mean(vr) and the
RMS, and the global norm, sum over the mesh axes that shard the reduced
dimensions (`sharding.tp.total`'s counted all-reduces); AdamW stays
elementwise.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.sharding import tp


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
# the layout: groups of the reference's leaves, and the mesh axes of a block
# --------------------------------------------------------------------------

class Group(NamedTuple):
    names: tuple      # the port's parameter names, in unit order
    stacked: bool     # a body slot's leaf, stacked over the units in the reference


def param_groups(cfg, names) -> dict:
    """The reference's leaves over the port's parameter names (a model's
    `named_parameters()` order): body slot j's parameter `rest` of every
    unit -> "body.slot{j}.{rest}" (body slot j of unit u is layer n_prefix
    + u len(kinds) + j, `models.model.unit_spec`); every other name (the
    prefix layers, `mtp`, embed, the head and final norm) its own group."""
    from repro_torch.models.model import unit_spec

    spec = unit_spec(cfg)
    groups: dict = {}
    for name in names:
        parts = name.split(".")
        if parts[0] == "layers" and int(parts[1]) >= spec.n_prefix:
            j = (int(parts[1]) - spec.n_prefix) % len(spec.kinds)
            key = f"body.slot{j}." + ".".join(parts[2:])
            groups.setdefault(key, []).append(name)
        else:
            groups[name] = [name]
    return {k: Group(tuple(v), k.startswith("body.")) for k, v in groups.items()}


def flat_groups(params) -> dict:
    """Every name its own unstacked leaf: the groups of a flat name ->
    tensor tree (no model's layers; those take `param_groups`)."""
    layers = [n for n in params if n.startswith("layers.")]
    if layers:
        raise ValueError(f"{layers[0]!r} is a model's layer: its groups are "
                         f"param_groups(cfg, params)")
    return {n: Group((n,), False) for n in params}


def _axes(specs: dict | None, name: str, ndim: int) -> list:
    """The mesh axes that shard each dimension of parameter `name`'s block
    (`specs` name -> partition spec; None: no mesh, no axes)."""
    if specs is None:
        return [()] * ndim
    return [tp.axes_of(e) for e in specs[name]]


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------

def global_norm(tensors: dict, specs: dict | None = None) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x^2), each in float32.  With
    `specs` (under the mesh context) each leaf's local sum is summed over
    the axes that shard it (a leaf replicated over an axis counted once):
    one all-reduce an axis of each distinct set of sharding axes."""
    if specs is None:
        leaves = [torch.sum(torch.square(x.float())) for x in tensors.values()]
        return torch.sqrt(torch.sum(torch.stack(leaves)))
    by_axes: dict = {}
    for name, x in tensors.items():
        axes = tuple(sorted({a for e in _axes(specs, name, x.dim()) for a in e}))
        by_axes.setdefault(axes, []).append(torch.sum(torch.square(x.float())))
    parts = [tp.total(torch.sum(torch.stack(v)), axes, "grad_norm")
             for axes, v in sorted(by_axes.items())]
    return torch.sqrt(torch.sum(torch.stack(parts)))


def clip_by_global_norm(grads: dict, max_norm: float, specs: dict | None = None):
    """(grads scaled by min(1, max_norm / norm), norm): new tensors, the
    scale cast to each gradient's dtype as in the reference."""
    norm = global_norm(grads, specs)
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


def adafactor_init(params: dict, groups: dict) -> dict:
    """{"v": group -> its state, "count" (int32, 0)}, float32 zeros.  A
    group of one unstacked parameter: {"vr" (rows), "vc" (columns)} for
    two or more dims, else {"v"}.  A stacked group of n layers: the
    reference's state of the (n, ...) leaf, {"vr" (n, *rows), "vc" (n,
    *columns)} for matrices, {"vr" (n,), "vc" (d,)} for vectors."""

    def init(group: Group):
        p = params[group.names[0]]
        shape, dev = tuple(p.shape), p.device
        lead = (len(group.names),) if group.stacked else ()
        if group.stacked or _factored(shape):
            full = lead + shape
            return {"vr": torch.zeros(full[:-1], dtype=torch.float32, device=dev),
                    "vc": torch.zeros(full[:-2] + full[-1:], dtype=torch.float32,
                                      device=dev)}
        return {"v": torch.zeros_like(p, dtype=torch.float32)}

    dev = next(iter(params.values())).device
    return {"v": {k: init(g) for k, g in groups.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


class _Stats:
    """One group's reductions: means over dims that a mesh may shard."""

    def __init__(self, axes: list):
        self.axes = axes

    def mean(self, t: torch.Tensor, dim: int, pdim: int | None = None) -> torch.Tensor:
        """mean of t over its `dim`, which is the parameter's dim `pdim`
        (default `dim`; both counted from the end), whole over the axes
        that shard that dim."""
        axes = self.axes[dim if pdim is None else pdim]
        full = t.shape[dim] * tp.size(axes)
        return tp.total(torch.sum(t, dim=dim), axes, "adafactor") / full


def _clip_scale(sum_sq: torch.Tensor, count: int, axes, cfg: OptConfig):
    """1 / max(1, rms / clip_threshold), rms over `count` elements whose
    local squares sum to sum_sq, summed over `axes`."""
    sum_sq = tp.total(sum_sq, axes, "adafactor")
    rms = torch.sqrt(sum_sq / count + 1e-30)
    return torch.clamp_min(rms / cfg.clip_threshold, 1.0)


def _apply(p: torch.Tensor, update: torch.Tensor, cfg: OptConfig) -> None:
    update = update + cfg.weight_decay * p.float()
    p.copy_(p.float() - cfg.lr * update)


def _adafactor_single(g, v, p, beta, cfg, st: _Stats, all_axes, n_full: int) -> None:
    g = g.float()
    g2 = g * g + 1e-30
    if _factored(g.shape):
        v["vr"].copy_(beta * v["vr"] + (1 - beta) * st.mean(g2, -1))
        v["vc"].copy_(beta * v["vc"] + (1 - beta) * st.mean(g2, -2))
        denom = torch.clamp_min(st.mean(v["vr"], -1, -2).unsqueeze(-1), 1e-30)
        vhat = (v["vr"][..., None] * v["vc"][..., None, :]) / denom[..., None]
    else:
        v["v"].copy_(beta * v["v"] + (1 - beta) * g2)
        vhat = v["v"]
    update = g / torch.sqrt(vhat + 1e-30)
    # update clipping (Shazeer & Stern)
    update = update / _clip_scale(torch.sum(update * update), n_full, all_axes, cfg)
    _apply(p, update, cfg)


def _adafactor_vectors(gs, v, ps, beta, cfg, st: _Stats, all_axes, n_full: int) -> None:
    """A stacked group of 1-D parameters, as the reference's (n, d) leaf
    (its gradients stacked: n d floats)."""
    g = torch.stack([x.float() for x in gs])
    g2 = g * g + 1e-30
    v["vr"].copy_(beta * v["vr"] + (1 - beta) * st.mean(g2, -1))
    v["vc"].copy_(beta * v["vc"] + (1 - beta) * torch.mean(g2, dim=0))
    denom = torch.clamp_min(torch.mean(v["vr"]), 1e-30)
    vhat = (v["vr"][:, None] * v["vc"][None, :]) / denom
    update = g / torch.sqrt(vhat + 1e-30)
    update = update / _clip_scale(torch.sum(update * update), n_full, all_axes, cfg)
    for u, p in enumerate(ps):
        _apply(p, update[u], cfg)


def _adafactor_matrices(gs, v, ps, beta, cfg, st: _Stats, all_axes, n_full: int) -> None:
    """A stacked group of matrices (or expert stacks), a layer at a time:
    the statistics and the update's sum of squares, then the update."""
    def vhat_of(u):
        vr, vc = v["vr"][u], v["vc"][u]
        denom = torch.clamp_min(st.mean(vr, -1, -2).unsqueeze(-1), 1e-30)
        return (vr[..., None] * vc[..., None, :]) / denom[..., None]

    sum_sq = None
    for u, g in enumerate(gs):
        g = g.float()
        g2 = g * g + 1e-30
        v["vr"][u].copy_(beta * v["vr"][u] + (1 - beta) * st.mean(g2, -1))
        v["vc"][u].copy_(beta * v["vc"][u] + (1 - beta) * st.mean(g2, -2))
        update = g / torch.sqrt(vhat_of(u) + 1e-30)
        s = torch.sum(update * update)
        sum_sq = s if sum_sq is None else sum_sq + s
        del g2, update
    scale = _clip_scale(sum_sq, n_full, all_axes, cfg)
    for u, (g, p) in enumerate(zip(gs, ps)):
        g = g.float()
        _apply(p, g / torch.sqrt(vhat_of(u) + 1e-30) / scale, cfg)


@torch.no_grad()
def adafactor_update(grads: dict, state: dict, params: dict, cfg: OptConfig,
                     groups: dict, specs: dict | None = None):
    if set(groups) != set(state["v"]):
        raise ValueError("this Adafactor state was built for other leaves: build it with "
                         "init_opt(name, params, groups) for the groups the update gets "
                         "(a model's: param_groups(cfg, params))")
    count = state["count"] + 1
    beta = 1.0 - count.float() ** (-cfg.decay)
    for key, group in groups.items():
        first = group.names[0]
        p0 = params[first]
        axes = _axes(specs, first, p0.dim())
        all_axes = tuple(sorted({a for e in axes for a in e}))
        n_full = p0.numel() * tp.size(all_axes) * len(group.names)
        st = _Stats(axes)
        gs = [grads[n] for n in group.names]
        ps = [params[n] for n in group.names]
        if not group.stacked:
            _adafactor_single(gs[0], state["v"][key], ps[0], beta, cfg, st, all_axes, n_full)
        elif p0.dim() == 1:
            _adafactor_vectors(gs, state["v"][key], ps, beta, cfg, st, all_axes, n_full)
        else:
            _adafactor_matrices(gs, state["v"][key], ps, beta, cfg, st, all_axes, n_full)
    state["count"] = count
    return params, state


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

def init_opt(name: str, params: dict, groups: dict) -> dict:
    """The state of optimizer `name` for `params`; Adafactor's by `groups`
    (`param_groups(cfg, params)` for a model, `flat_groups(params)` for a
    flat tree; AdamW's is elementwise and ignores them)."""
    return adamw_init(params) if name == "adamw" else adafactor_init(params, groups)


def apply_opt(name: str, grads: dict, state: dict, params: dict, cfg: OptConfig,
              groups: dict, specs: dict | None = None):
    """One update of `params` (name -> tensor, written in place) from
    `grads`; returns (params, state), both updated in place.  Adafactor
    takes the state's `groups`; under the mesh context, `specs` (name ->
    partition spec) reduce its statistics over the sharding axes."""
    if name == "adamw":
        return adamw_update(grads, state, params, cfg)
    return adafactor_update(grads, state, params, cfg, groups, specs)
