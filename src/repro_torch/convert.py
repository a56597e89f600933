"""Carry state, index structures and LM weights into the port as numpy
arrays.

A cache state (whole, or a rank's block of it for the sharded step), an
index (flat, IVF, IVF-PQ, LSH, NSW, the sharded IVF) or an LM's
parameters built elsewhere, for instance by the JAX reference, are handed
over as plain arrays, so the port never reads a framework-specific object
such as a JAX key.

An index whose catalog has mutated loads the same way: `catalog` is the
slab at its capacity, `valid` its (capacity,) liveness mask and `n_slots`
its high-water mark, beside the structures as they stand (`invlists`,
`codes` (capacity, m), `buckets`, `graph` (capacity, degree)).  The lists'
append cursors are their counts of ids (lists fill from column 0 and
tombstones stay in them), so they come with the tables.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.policy import CacheState
from repro_torch.index.exact import FlatIndex
from repro_torch.index.ivf import IVFFlatIndex
from repro_torch.index.lsh import LSHIndex
from repro_torch.index.nsw import NSWIndex
from repro_torch.index.pq import IVFPQIndex
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM, init_params, unit_spec


def cache_state_from_numpy(y, x, t: int = 0, seed: int = 0, device=None) -> CacheState:
    """CacheState from (N,) float arrays y and x and the step counter t;
    the step generator is a fresh one on `device`, seeded with `seed`."""
    device = resolve_device(device)
    y = torch.from_numpy(np.array(y, np.float32)).to(device)
    x = torch.from_numpy(np.array(x, np.float32)).to(device)
    return CacheState(y=y, x=x, t=int(t),
                      gen=torch.Generator(device=device).manual_seed(seed))


def cache_state_block(y, x, mesh, t: int = 0, seed: int = 0, model_axis: str = "model",
                      device=None) -> CacheState:
    """This rank's block of a whole (N,) state given as numpy y and x (the
    sharded step's state); the generator as `cache_state_from_numpy`'s,
    on the mesh's device by default."""
    from repro_torch.core.distributed import block_of, mesh_device

    device = mesh_device(mesh) if device is None else device
    return cache_state_from_numpy(block_of(np.asarray(y), mesh, model_axis),
                                  block_of(np.asarray(x), mesh, model_axis), t, seed, device)


def gather_state(state: CacheState, mesh, model_axis: str = "model"):
    """(y, x) of the whole state as numpy arrays, gathered from every
    rank's block (a collective: every rank of the mesh calls it)."""
    from repro_torch.core.distributed import gather_rows

    return tuple(gather_rows(t, mesh, model_axis).cpu().numpy() for t in (state.y, state.x))


def sharded_ivf_from_numpy(centroids, invlists, nlist: int, nprobe: int, device=None):
    """ShardedIVF from the reference's stacked per-shard structures:
    centroids (P nlist, d) and invlists (P nlist, cap) of local row ids,
    -1 padded (`repro.core.distributed.build_sharded_ivf`'s layout)."""
    from repro_torch.core.distributed import ShardedIVF

    device = resolve_device(device)
    centroids = np.array(centroids, np.float32)
    invlists = np.array(invlists, np.int32)
    if centroids.shape[0] % nlist or invlists.shape[0] != centroids.shape[0]:
        raise ValueError(f"sharded IVF: centroids {centroids.shape} and invlists "
                         f"{invlists.shape} are not whole shards of nlist {nlist}")
    return ShardedIVF(torch.from_numpy(centroids).to(device).contiguous(),
                      torch.from_numpy(invlists).to(device).contiguous(), int(nlist),
                      int(nprobe))


def _mutated(index, valid, n_slots):
    """The index with a mutated slab's mask and high-water mark (valid None:
    every row of the catalog live)."""
    if valid is not None:
        index._load_rows(valid, int(n_slots))
    return index


def flat_from_numpy(catalog, valid=None, n_slots=None, device=None) -> FlatIndex:
    """FlatIndex over `catalog` (the slab), `valid` / `n_slots` as above."""
    return _mutated(FlatIndex(np.array(catalog, np.float32), device=device), valid,
                    n_slots)


def ivf_from_numpy(catalog, centroids, invlists, nprobe: int, valid=None,
                   n_slots=None, init_fn=None, device=None) -> IVFFlatIndex:
    """IVFFlatIndex over `catalog` (N, d) with prebuilt `centroids`
    (nlist, d) and padded inverted lists `invlists` (nlist, cap; -1 pads);
    `init_fn` gives later rebuilds' initial rows."""
    return _mutated(IVFFlatIndex(np.array(catalog, np.float32), len(centroids), nprobe,
                                 centroids=np.array(centroids, np.float32),
                                 invlists=np.array(invlists, np.int32), init_fn=init_fn,
                                 device=device), valid, n_slots)


def ivfpq_from_numpy(catalog, centroids, invlists, codebooks, codes,
                     nprobe: int, refine: int, valid=None, n_slots=None, init_fn=None,
                     pq_init_fn=None, device=None) -> IVFPQIndex:
    """IVFPQIndex over `catalog` (N, d) with the prebuilt coarse layer,
    `codebooks` (m, ksub, d // m) and `codes` (N, m) in [0, ksub)."""
    codebooks = np.array(codebooks, np.float32)
    return _mutated(IVFPQIndex(np.array(catalog, np.float32), len(centroids), nprobe,
                               m=codebooks.shape[0], refine=refine,
                               centroids=np.array(centroids, np.float32),
                               invlists=np.array(invlists, np.int32), codebooks=codebooks,
                               codes=np.array(codes), init_fn=init_fn,
                               pq_init_fn=pq_init_fn, device=device), valid, n_slots)


def lsh_from_numpy(catalog, planes, buckets, valid=None, n_slots=None, cap=None,
                   device=None) -> LSHIndex:
    """LSHIndex over `catalog` with hyperplanes `planes` (tables, bits, d)
    and the bucket table `buckets` (tables, 2**bits, cap; -1 pads); `cap`
    a fixed bucket width (truncation on add)."""
    return _mutated(LSHIndex(np.array(catalog, np.float32), cap=cap,
                             planes=np.array(planes, np.float32),
                             buckets=np.array(buckets, np.int32), device=device),
                    valid, n_slots)


def nsw_from_numpy(catalog, graph, entry_points, beam: int, steps: int,
                   expand: int, valid=None, n_slots=None, seed: int = 0, init_fn=None,
                   device=None) -> NSWIndex:
    """NSWIndex over `catalog` with the neighbour table `graph` (N, degree)
    and the beam's `entry_points`, searched with (beam, steps, expand).
    `seed` is the build's (insertions draw from `default_rng(seed + 1)`,
    rebuilds from `seed`); a loaded index's insertion generator starts
    fresh."""
    return _mutated(NSWIndex(np.array(catalog, np.float32), beam=beam, steps=steps,
                             expand=expand, seed=seed, graph=np.array(graph, np.int32),
                             entry_points=np.array(entry_points, np.int32),
                             init_fn=init_fn, device=device), valid, n_slots)


def lm_params_from_numpy(params, cfg: ModelConfig, device=None) -> LM:
    """The port's model holding the reference's LM parameters.

    `params` is the reference's nested tree as numpy arrays: `embed`
    (vocab, d), `final_norm` (d,), `lm_head` (d, vocab) unless tied;
    `prefix.layer{i}` (the unrolled layers, unstacked); `body.slot{j}`,
    each leaf stacked over the units; and `mtp.{proj, block, norm}` when
    cfg.mtp_depth.  A layer's leaves are `norm1`, `norm2` (not on a pure
    mamba block), `mixer.*` (GQA `wq, wk, wv, wo[, bq, bk, bv]`; MLA
    `wq_a, q_norm, wq_b` or `wq`, `wkv_a, kv_norm, wk_b, wv_b, wo`; mamba
    `in_proj, conv_w, conv_b, a_log, dt_bias, d_skip, norm_w, out_proj`)
    and `ffn.*` (`wi[, wg], wo`; MoE `router, wi, wg, wo[, shared.*]`).
    Body slot j of unit u goes to layer n_prefix + u * len(kinds) + j.
    Weights keep their layout and are cast to each parameter's dtype;
    every leaf of the tree must land on a parameter of the same shape."""
    model = init_params(cfg, seed=0, device=device)
    spec = unit_spec(cfg)
    used = set()

    def put(dst: torch.Tensor, tree, where: str, path: str, unit: int | None) -> None:
        node = tree
        for key in path.split("."):
            node = node[key]
        src = torch.from_numpy(np.array(node if unit is None else node[unit], np.float32))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"lm_params_from_numpy: {where}{path} has shape "
                             f"{tuple(src.shape)} for a {tuple(dst.shape)} parameter")
        dst.copy_(src.to(dst.dtype))
        used.add(where + path)

    def put_module(module, tree, where: str, unit: int | None = None) -> None:
        for name, t in module.named_parameters():
            put(t, tree, where, name, unit)

    with torch.no_grad():
        for name in ("embed", "final_norm") + (() if cfg.tie_embeddings else ("lm_head",)):
            put(getattr(model, name), params, "", name, None)
        for i, layer in enumerate(model.layers):
            if i < spec.n_prefix:
                put_module(layer, params["prefix"][f"layer{i}"], f"prefix.layer{i}.")
            else:
                u, j = divmod(i - spec.n_prefix, len(spec.kinds))
                put_module(layer, params["body"][f"slot{j}"], f"body.slot{j}.", u)
        if cfg.mtp_depth:
            put_module(model.mtp, params["mtp"], "mtp.")
    missing = set(_paths(params)) - used
    if missing:
        raise ValueError(f"lm_params_from_numpy: leaves with no parameter: {sorted(missing)}")
    return model


def mesh_coords(mesh) -> tuple:
    """({axis: ranks}, {axis: this rank's coordinate}) of a DeviceMesh."""
    names = tuple(mesh.mesh_dim_names)
    return (dict(zip(names, (int(n) for n in mesh.mesh.shape))),
            {a: mesh.get_local_rank(a) for a in names})


def param_block(t: torch.Tensor, spec: tuple, mesh_shape: dict, coords: dict):
    """The block of the whole tensor `t` that the rank at `coords` holds
    under `spec`: along each dim split over axes (a1, a2, ...), slice r of
    n, n the product of their sizes and r the row-major coordinate (a
    view)."""
    from repro_torch.sharding.tp import axes_of

    for dim, entry in enumerate(spec):
        n, r = 1, 0
        for a in axes_of(entry):
            n, r = n * mesh_shape[a], r * mesh_shape[a] + coords[a]
        if n > 1:
            size = t.shape[dim] // n
            t = t.narrow(dim, r * size, size)
    return t


def block_views(module, cfg: ModelConfig, mesh_shape: dict, coords: dict) -> dict:
    """name -> (the rank's block of the module's parameter, as a view; its
    spec) over a mesh of `mesh_shape` at `coords`, with no world: the
    shares of a (1, 4) mesh built on one card."""
    from repro_torch.sharding import specs as S

    out = {}
    for name, p in module.named_parameters():
        spec = S.param_pspec(name, p.shape, cfg, mesh_shape)
        out[name] = (param_block(p, spec, mesh_shape, coords), spec)
    return out


def shard_module(module, cfg: ModelConfig, mesh=None, *, mesh_shape: dict | None = None,
                 coords: dict | None = None, whole=()):
    """Cut every parameter of a whole module (an `LM`, a layer, an MoE) in
    place to the rank's block by `sharding.specs`, recording its spec as
    the parameter's `pspec`, and return the module.  The rank is this
    process's on `mesh`, or the one at `coords` on a mesh of `mesh_shape`
    (no world needed).  A parameter whose name starts with a prefix in
    `whole` stays whole, its spec replicated.  A block that is the whole
    tensor keeps its storage; any other is a copy, so the whole tensor can
    be freed."""
    from torch import nn

    if mesh is not None:
        mesh_shape, coords = mesh_coords(mesh)
    for name, (block, spec) in block_views(module, cfg, mesh_shape, coords).items():
        *path, leaf = name.split(".")
        owner = module
        for key in path:
            owner = getattr(owner, key)
        p = getattr(owner, leaf)
        if any(name.startswith(w + ".") for w in whole):
            block, spec = p, (None,) * p.dim()
        if block.shape != p.shape:
            p = nn.Parameter(block.detach().clone(), requires_grad=p.requires_grad)
            setattr(owner, leaf, p)
        p.pspec = tuple(spec)
    return module


def moe_block(moe, cfg: ModelConfig, mesh):
    """Cut a whole MoE layer (`models.moe.MoE`) to this rank's block, in
    place, and return it, as the reference's `_moe_shard_map` cuts it
    (`src/repro/models/moe.py:199-206`): wi / wg / wo keep the rank's E /
    n_model experts (E over `model`; where E does not divide the axis,
    every expert and the rank's block of the expert FFN dim, the
    reference's TP inside experts), and under cfg.fsdp the router, wi, wg
    and wo keep only the rank's `data` slice of d.  The shared experts
    stay whole."""
    return shard_module(moe, cfg, mesh, whole=("shared",))


def lm_params_block(params, cfg: ModelConfig, mesh=None, device=None, *,
                    mesh_shape: dict | None = None, coords: dict | None = None) -> LM:
    """This rank's model from the reference's numpy tree
    (`lm_params_from_numpy`'s layout), on the mesh's device by default:
    every parameter cut by the specs (`shard_module`).  Without a world,
    `mesh_shape` and `coords` name the rank (then `device` is required)."""
    from repro_torch.core.distributed import mesh_device

    if device is None:
        device = mesh_device(mesh)
    model = lm_params_from_numpy(params, cfg, device=device)
    return shard_module(model, cfg, mesh, mesh_shape=mesh_shape, coords=coords)


def lm_params_to_numpy(model: LM, cfg: ModelConfig, tensors: dict | None = None) -> dict:
    """The reference's nested LM tree (the layout `lm_params_from_numpy`
    reads) as float32 numpy arrays: from the model's parameters, or from
    `tensors`, a dict by the model's parameter names (its gradients, say;
    a name missing from it gives zeros).  Body slot j's leaves are stacked
    over the units, in unit order."""
    spec = unit_spec(cfg)
    named = dict(model.named_parameters())

    def leaf(name: str) -> np.ndarray:
        t = named[name] if tensors is None else tensors.get(name)
        if t is None:
            return np.zeros(tuple(named[name].shape), np.float32)
        return t.detach().float().cpu().numpy()

    def nest(tree: dict, path: str, value) -> None:
        *heads, last = path.split(".")
        for key in heads:
            tree = tree.setdefault(key, {})
        tree[last] = value

    out: dict = {}
    for name in ("embed", "final_norm") + (() if cfg.tie_embeddings else ("lm_head",)):
        out[name] = leaf(name)
    body: dict = {}
    for i, layer in enumerate(model.layers):
        for pname, _ in layer.named_parameters():
            value = leaf(f"layers.{i}.{pname}")
            if i < spec.n_prefix:
                nest(out, f"prefix.layer{i}.{pname}", value)
            else:
                j = (i - spec.n_prefix) % len(spec.kinds)
                body.setdefault(f"slot{j}.{pname}", []).append(value)
    for path, values in body.items():
        nest(out, f"body.{path}", np.stack(values))
    if cfg.mtp_depth:
        for pname, _ in model.mtp.named_parameters():
            nest(out, f"mtp.{pname}", leaf(f"mtp.{pname}"))
    return out


def _paths(tree, prefix: str = ""):
    """Dotted paths of a nested dict's leaves."""
    for key, node in tree.items():
        if isinstance(node, dict):
            yield from _paths(node, f"{prefix}{key}.")
        else:
            yield prefix + key
