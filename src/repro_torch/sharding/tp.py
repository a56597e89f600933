"""The specs' layout at run time: what a layer under `sharding.ctx`'s mesh
context needs to run on the rank's blocks.

A rank of a (data, model) mesh, or of (pod, data, model), holds exactly the
block of every parameter that `sharding.specs.param_pspecs` gives it
(`convert.shard_module` / `lm_params_block` cut it, and record the spec on
the parameter as `pspec`), and serves or trains its `data` slice of the
batch.  The layers read the specs from here:

  - `spec_of(p)`: a parameter's spec; under a mesh a parameter without
    one raises (a model that was not cut would run whole on every rank);
  - `gathered(module)`: the module's parameters whole over `data` (the
    fsdp gather before use, `core.distributed.gather_shards`, whose
    backward reduce-scatters the gradient over `data`);
  - `over_model(spec)`: whether a dimension of the spec splits over the
    `model` axis (then the layer's output is a partial, reduced over
    `model`, and its replicated input takes `replicated_input`).

Every layer runs at any (data, model) mesh: the attention and FFN
(`models/layers.py`), MLA (`models/mla.py`), the Mamba2 mixer
(`models/ssm.py`), the MoE (`models/moe.py`), the embedding, head and
losses, and the MTP head (`models/model.py`).

Collective sites (`core.distributed.COLLECTIVE_SITES`): "fsdp" (the dense
weights' data gathers), "embed" (the vocab-parallel lookup), "attn_in" /
"attn_out" / "attn_heads" (the attention's replicated input, its partial
and a misaligned projection's model gather), "mlp_in" / "mlp_out",
"logits_in" (the head's input), "mla_q_a" / "mla_kv_a" / "mla_heads" /
"mla_out" / "mla_in" (MLA's latent gathers, a misaligned head
projection's gather, its partial and its replicated inputs), "ssm_in" /
"ssm_conv" / "ssm_norm" / "ssm_out" / "ssm_mark" (the Mamba2 mixer's
in_proj and conv gathers, the norm's sum of squares, its partial and its
replicated inputs), "mtp_proj" / "mtp_in" (the MTP head's residual
gather and its input), "ce" and "ce_max" (the vocab-parallel
loss over `model`), "loss" (the loss's sums over the batch axes),
"sample" (greedy tokens over vocab shards; `vocab_shard` says whether
the logits are), "attn_bias" (a split bias of a whole matrix,
`gather_model_replicated`), "grad_sync" (gradients of
parameters not sharded over a batch axis), "grad_norm" and "adafactor";
the MoE's own (models/moe.py), "attn_seq" (the partial softmax rows of
an attention or MLA decode over a sequence-sharded cache, gathered over
the batch axes: `seq_shard`).  A backward's collective is counted at its
forward's site + ".grad".

A cache leaf that `models.init_cache` built under the mesh context carries
its spec as `pspec` too; `seq_shard` reads from it whether its sequence
splits over the batch axes (`specs.cache_pspec`, where the context's batch
is whole).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, NamedTuple

import torch

from repro_torch.sharding import ctx as mesh_ctx

DATA, MODEL = "data", "model"


def axes_of(entry) -> tuple:
    """The mesh axes of one spec entry (None, a name or a tuple of names)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_of(p: torch.Tensor) -> tuple:
    spec = getattr(p, "pspec", None)
    if spec is None:
        raise ValueError(
            f"a {tuple(p.shape)} parameter has no partition spec: under a mesh every "
            f"parameter is the rank's block of the specs' layout (cut the model with "
            f"convert.shard_module or convert.lm_params_block)")
    return spec


def dims_over(spec, axis: str) -> list:
    return [d for d, e in enumerate(spec) if axis in axes_of(e)]


def over_model(spec) -> bool:
    return bool(dims_over(spec, MODEL))


def size(axis) -> int:
    """Ranks of `axis` on the current mesh: a name, or a tuple of names
    (their product; 1 for none); 1 with no mesh."""
    from repro_torch.core.distributed import _axis_size

    ctx = mesh_ctx.current()
    return 1 if ctx is None else _axis_size(ctx.mesh, axis)


def rank(axis: str) -> int:
    from repro_torch.core.distributed import _axis_rank

    ctx = mesh_ctx.current()
    return 0 if ctx is None else _axis_rank(ctx.mesh, axis)


def total(t: torch.Tensor, axes, site: str) -> torch.Tensor:
    """t summed over the ranks of each of `axes` on the current mesh: one
    counted all-reduce an axis, no gradient (no axes: t itself)."""
    if not axes:
        return t
    ctx = mesh_ctx.current()
    if ctx is None:
        raise ValueError(f"a sum over the mesh axes {tuple(axes)} needs the mesh context")
    from repro_torch.core.distributed import all_reduce

    for a in axes:
        t = all_reduce(t, ctx.mesh, a, site)
    return t


def whole_over_data(p: torch.Tensor, site: str = "fsdp") -> torch.Tensor:
    """The parameter gathered over `data` along each dim its spec shards
    over `data` (itself where none does)."""
    mesh = mesh_ctx.current().mesh
    from repro_torch.core.distributed import gather_shards

    out = p
    for d in dims_over(spec_of(p), DATA):
        out = gather_shards(out, mesh, DATA, d, site)
    return out


def gathered(module, site: str = "fsdp") -> SimpleNamespace:
    """The module's direct parameters, each whole over `data`, by name;
    `specs` holds their specs."""
    named = dict(module.named_parameters(recurse=False))
    out = SimpleNamespace(**{n: whole_over_data(p, site) for n, p in named.items()})
    out.specs = {n: spec_of(p) for n, p in named.items()}
    return out


def replicated_input(x: torch.Tensor, site: str) -> torch.Tensor:
    from repro_torch.core.distributed import replicated_input as rep

    return rep(x, mesh_ctx.current().mesh, MODEL, site)


def reduce_model(x: torch.Tensor, site: str) -> torch.Tensor:
    from repro_torch.core.distributed import reduce_partials

    return reduce_partials(x, mesh_ctx.current().mesh, MODEL, site)


def gather_model(x: torch.Tensor, dim: int, site: str) -> torch.Tensor:
    from repro_torch.core.distributed import gather_shards

    return gather_shards(x, mesh_ctx.current().mesh, MODEL, dim, site)


def gather_model_replicated(x: torch.Tensor, dim: int, site: str) -> torch.Tensor:
    """`gather_model` for a tensor every rank of `model` then uses alike
    (a split bias of a whole matrix): its backward takes the rank's block
    of the gradient without summing the ranks' (already whole) ones."""
    from repro_torch.core.distributed import gather_replicated

    return gather_replicated(x, mesh_ctx.current().mesh, MODEL, dim, site)


def vocab_shard(head: torch.Tensor, vocab_dim: int) -> int | None:
    """The first vocab id of the rank's logit columns where the mesh
    context splits the head's vocab dimension (`vocab_dim` of `head`:
    lm_head's 1, the tied embed's 0) over a `model` axis of more than one
    rank; None where the logits are whole (no mesh, or a head whole over
    `model`).  The loss and the token choice take this answer; nothing
    else decides whether logits are vocab-sharded."""
    if mesh_ctx.current() is None or size(MODEL) == 1:
        return None
    if MODEL not in axes_of(spec_of(head)[vocab_dim]):
        return None
    return rank(MODEL) * head.shape[vocab_dim]


def reduce_batch(x: torch.Tensor, site: str) -> torch.Tensor:
    """The sum over the batch axes (`reduce_partials` over each): the
    global batch's sums from the ranks' data slices."""
    from repro_torch.core.distributed import reduce_partials

    ctx = mesh_ctx.current()
    for a in ctx.batch_axes:
        x = reduce_partials(x, ctx.mesh, a, site)
    return x


class SeqShard(NamedTuple):
    """A rank's block of a cache leaf whose sequence splits over the batch
    axes: its slots are [lo, lo + its length) of the `whole` cache's, and
    `exchange(t)` returns every rank's `t` stacked (n, ...) in rank order
    (row-major over the axes)."""
    lo: int
    whole: int
    exchange: Callable


def seq_shard(leaf: torch.Tensor, dim: int = 1) -> SeqShard | None:
    """The rank's block of `leaf`'s sequence dim `dim` where its spec (the
    `pspec` `models.init_cache` recorded) splits it over mesh axes, its
    exchange the counted all-gather over them (site "attn_seq", one call an
    axis of more than one rank, innermost first); None with no mesh
    context, no spec or a whole sequence."""
    ctx = mesh_ctx.current()
    spec = getattr(leaf, "pspec", None)
    axes = () if ctx is None or spec is None else axes_of(spec[dim])
    if not axes:
        return None
    from repro_torch.core.distributed import _axis_rank, _axis_size, all_gather_axes

    mesh, t = ctx.mesh, leaf.shape[dim]
    return SeqShard(_axis_rank(mesh, axes) * t, _axis_size(mesh, axes) * t,
                    lambda x: all_gather_axes(x, mesh, axes, "attn_seq"))
