"""Partition specs for parameters, optimizer state, batches and caches
(port of `repro.sharding.specs`), and the per-device bytes they give.

A spec is a tuple with one entry a tensor dimension: None (replicated),
a mesh axis name, or a tuple of names (the dimension split over several
axes, row-major), as the reference's `PartitionSpec`s are.  The port's
layers are unstacked, so a body layer's spec is the reference's without
its leading `body` unit axis.

TP: head / FFN / expert dims shard over `model`.  FSDP (cfg.fsdp): the
other matrix dim shards over `data` too.  EP: expert-stacked weights
shard E over `model` when E divides by the axis, else the expert-internal
FFN dims shard (TP inside each expert).  DP: the batch dim shards over
("pod", "data").

Every rule passes through the divisibility check (`check`): an axis that
does not divide its dimension is dropped (replicated), so one rule set
serves all ten architectures.

Specs are computed over `mesh_shape` dicts ({"data": 16, "model": 16}),
so they need no world; `placements(spec, mesh)` turns one into
`torch.distributed.tensor` placements on a real mesh.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

# param-name -> (axis per dim) templates; 'F' = the fsdp axis (data, if on)
_RULES_2D = {
    "embed": ("model", "F"),
    "lm_head": ("F", "model"),
    "wq": ("F", "model"), "wk": ("F", "model"), "wv": ("F", "model"),
    "wo": ("model", "F"),
    "wi": ("F", "model"), "wg": ("F", "model"),
    "in_proj": ("F", "model"), "out_proj": ("model", "F"),
    "wq_a": ("F", "model"), "wq_b": ("F", "model"),
    "wkv_a": ("F", "model"), "wk_b": ("F", "model"), "wv_b": ("F", "model"),
    "router": ("F", None),
    "proj": ("F", "model"),
    "conv_w": (None, "model"),
}
_RULES_1D_MODEL = {"bq", "bk", "bv", "conv_b", "a_log", "dt_bias", "d_skip", "norm_w"}


def axis_size(mesh_shape: dict, axis) -> int:
    """Ranks along a spec entry: 1 for None, the product for a tuple."""
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh_shape.get(a, 1)
        return n
    return mesh_shape.get(axis, 1)


def _entry(axis):
    """A one-name tuple is the name (as `PartitionSpec` normalises it)."""
    return axis[0] if isinstance(axis, tuple) and len(axis) == 1 else axis


def check(spec_axes, shape, mesh_shape: dict) -> tuple:
    """`spec_axes` with every axis that does not divide its dimension
    replaced by None."""
    return tuple(_entry(axis) if axis and dim % axis_size(mesh_shape, axis) == 0 else None
                 for dim, axis in zip(shape, spec_axes))


def param_pspec(name: str, shape, cfg: ModelConfig, mesh_shape: dict) -> tuple:
    """The spec of the parameter `name` (a dotted path; its last part picks
    the rule) of `shape`."""
    name = name.rsplit(".", 1)[-1]
    shape = tuple(shape)
    fsdp = "data" if cfg.fsdp else None

    def t(axes):
        return check(tuple(fsdp if a == "F" else a for a in axes), shape, mesh_shape)

    if len(shape) == 3 and name in ("wi", "wg", "wo"):
        if shape[0] % axis_size(mesh_shape, "model") == 0:
            axes = ("model", fsdp, None) if name in ("wi", "wg") else ("model", None, fsdp)
        else:  # few experts: TP inside each expert instead
            axes = (None, fsdp, "model") if name in ("wi", "wg") else (None, "model", fsdp)
        return check(axes, shape, mesh_shape)
    if len(shape) == 2 and name in _RULES_2D:
        # attention projections whose HEAD counts do not divide the model
        # axis shard over data only (the reference's head-alignment rule)
        if cfg.replicate_misaligned_heads and name in ("wq", "wk", "wv", "wo"):
            msize = axis_size(mesh_shape, "model")
            heads = cfg.n_kv_heads if name in ("wk", "wv") else cfg.n_heads
            if heads and msize > 1 and heads % msize != 0:
                return check((fsdp, None) if name != "wo" else (None, fsdp), shape,
                             mesh_shape)
        return t(_RULES_2D[name])
    if len(shape) == 1 and name in _RULES_1D_MODEL:
        return t(("model",))
    # norms, scalars, everything else: replicated
    return (None,) * len(shape)


def param_pspecs(cfg: ModelConfig, params, mesh_shape: dict) -> dict:
    """name -> spec for every parameter of `params` (a model, e.g. one
    built on the meta device, or a dict name -> tensor)."""
    named = dict(params.named_parameters()) if hasattr(params, "named_parameters") \
        else params
    return {n: param_pspec(n, p.shape, cfg, mesh_shape) for n, p in named.items()}


def opt_pspecs(name: str, pspecs: dict, groups: dict) -> dict:
    """Specs of `repro_torch.train.optimizer.init_opt`'s state.  AdamW:
    master / m / v share the parameter's spec.  Adafactor, by `groups`
    (`optimizer.param_groups`, or `flat_groups` for a flat tree): "vr" drops
    the last dim's axis, "vc" the second-to-last; a stacked group's state
    leads with the unreplicated unit dim, as the reference's (n_units,
    ...) leaf (a 1-D parameter's: vr (n_units,) replicated, vc its spec);
    an unstacked 1-D parameter's "v" keeps its spec.  "count" is a
    replicated scalar."""
    if name == "adamw":
        return {"master": dict(pspecs), "m": dict(pspecs), "v": dict(pspecs), "count": ()}

    def factored(group):
        first = group.names[0]
        axes = ((None,) if group.stacked else ()) + tuple(pspecs[first])
        if len(axes) >= 2:
            return {"vr": axes[:-1], "vc": axes[:-2] + axes[-1:]}
        return {"v": axes}

    return {"v": {k: factored(g) for k, g in groups.items()}, "count": ()}


def batch_whole(global_batch: int, mesh_shape: dict, batch_ax) -> bool:
    """Whether a batch of `global_batch` stays whole on every rank: `check`
    drops the batch axes `batch_ax` (a name or a tuple) from its dim where
    they do not divide it (long-context decode's global batch 1), and the
    KV / latent caches then shard their sequence over those axes instead
    (`cache_pspec`).  The one divisibility rule of the batch: the mesh
    context decides it from here (`sharding.ctx.mesh_context`'s
    `global_batch`), and so do `batch_pspecs` and `cache_pspecs`."""
    return check((batch_ax,), (global_batch,), mesh_shape)[0] is None


def batch_pspecs(cfg: ModelConfig, batch_specs: dict, multi_pod: bool,
                 mesh_shape: dict | None = None) -> dict:
    """The batch dim of every input over ("pod", "data") (positions3's
    second dim); an axis that does not divide (global_batch 1) drops, as
    `batch_whole` says."""
    batch_ax = ("pod", "data") if multi_pod else ("data",)
    mesh_shape = mesh_shape or {}
    out = {}
    for k, v in batch_specs.items():
        if k == "positions3":
            axes = (None, batch_ax) + (None,) * (len(v.shape) - 2)
        else:
            axes = (batch_ax,) + (None,) * (len(v.shape) - 1)
        out[k] = check(axes, v.shape, mesh_shape)
    return out


def cache_pspec(name: str, shape, mesh_shape: dict, batch_ax, whole_batch: bool) -> tuple:
    """The spec of one leaf of `models.init_cache`'s per-layer dicts, by its
    name, over the whole `shape`: the batch over `batch_ax`, or, where the
    batch stays whole (`whole_batch`, `batch_whole`'s verdict), the
    sequence dim of the KV / latent caches over it; the kv-head / feature
    dim over `model` where it divides.  An axis that does not divide its
    dim drops (`check`): a sequence that does not divide the batch axes
    stays whole on every rank."""
    if name in ("k", "v"):            # (B, S, KV, D)
        axes = ((None, batch_ax, "model", None) if whole_batch
                else (batch_ax, None, "model", None))
    elif name in ("ckv", "krope"):    # (B, S, R)
        axes = (None, batch_ax, None) if whole_batch else (batch_ax, None, None)
    elif name == "conv":              # (B, K-1, CH)
        axes = (batch_ax, None, "model")
    elif name == "ssm":               # (B, H, P, N)
        axes = (batch_ax, "model", None, None)
    else:
        axes = (None,) * len(shape)
    return check(axes, shape, mesh_shape)


def cache_pspecs(cfg: ModelConfig, cache: list, mesh_shape: dict, multi_pod: bool) -> list:
    """Specs of `models.init_cache`'s per-layer dicts built whole (the global
    batch): `cache_pspec` of every leaf, the batch whole where
    `batch_whole` says so."""
    batch_ax = ("pod", "data") if multi_pod else ("data",)
    return [{name: cache_pspec(name, tuple(leaf.shape), mesh_shape, batch_ax,
                               batch_whole(leaf.shape[0], mesh_shape, batch_ax))
             for name, leaf in layer.items()}
            for layer in cache]


def local_shape(shape, spec: tuple, mesh_shape: dict) -> tuple:
    """A rank's block of a whole `shape` laid out by `spec`."""
    return tuple(dim // axis_size(mesh_shape, ax) for dim, ax in zip(shape, spec))


def _is_leaf(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _pairs(tree, specs):
    """(tensor, spec) for every tensor of `tree` (nested dicts and lists of
    tensors), its spec at the same place in `specs`."""
    if _is_leaf(tree):
        yield tree, specs
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, specs[k])
    else:
        for v, s in zip(tree, specs, strict=True):
            yield from _pairs(v, s)


def sharded_bytes(tree, specs, mesh_shape: dict) -> int:
    """Per-device bytes of `tree` (tensors, e.g. on the meta device) laid
    out by `specs` over a mesh of `mesh_shape` (analytic)."""
    total = 0
    for t, spec in _pairs(tree, specs):
        shards = 1
        for ax in spec:
            shards *= axis_size(mesh_shape, ax)
        total += t.numel() * t.element_size() // max(shards, 1)
    return total


def placements(spec: tuple, mesh) -> list:
    """`torch.distributed.tensor` placements of `spec` on `mesh` (a
    DeviceMesh): per mesh dimension, Shard(d) for the tensor dim d whose
    entry names it, else Replicate().  An axis the mesh lacks raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        for a in (() if ax is None else ax if isinstance(ax, tuple) else (ax,)):
            if a not in names:
                raise ValueError(f"spec {spec}: {a!r} is not an axis of the mesh {names}")
            out[names.index(a)] = Shard(dim)
    return out
