"""Carry state, index structures and LM weights into the port as numpy
arrays.

A cache state, an index (flat, IVF, IVF-PQ, LSH, NSW) or an LM's
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
from repro_torch.models.model import LM, init_params


def cache_state_from_numpy(y, x, t: int = 0, seed: int = 0, device=None) -> CacheState:
    """CacheState from (N,) float arrays y and x and the step counter t;
    the step generator is a fresh one on `device`, seeded with `seed`."""
    device = resolve_device(device)
    y = torch.from_numpy(np.array(y, np.float32)).to(device)
    x = torch.from_numpy(np.array(x, np.float32)).to(device)
    return CacheState(y=y, x=x, t=int(t),
                      gen=torch.Generator(device=device).manual_seed(seed))


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
    (vocab, d), `final_norm` (d,), `lm_head` (d, vocab) unless tied, and
    `body` stacked over the layers, `slot0.{norm1, norm2}`,
    `slot0.mixer.{wq, wk, wv, wo[, bq, bk, bv]}` and
    `slot0.ffn.{wi[, wg], wo}`.  Weights keep their (in, out) layout and
    are cast to cfg.dtype, so both compute the same function."""
    model = init_params(cfg, seed=0, device=device)

    def put(dst: torch.Tensor, src) -> None:
        src = torch.from_numpy(np.array(src, dtype=np.float32))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"lm_params_from_numpy: shape {tuple(src.shape)} "
                             f"for a {tuple(dst.shape)} parameter")
        dst.copy_(src.to(dst.dtype))

    with torch.no_grad():
        put(model.embed, params["embed"])
        put(model.final_norm, params["final_norm"])
        if not cfg.tie_embeddings:
            put(model.lm_head, params["lm_head"])
        body = params["body"]["slot0"]
        for i, layer in enumerate(model.layers):
            put(layer.norm1, body["norm1"][i])
            put(layer.norm2, body["norm2"][i])
            for name, t in layer.mixer.named_parameters():
                put(t, body["mixer"][name][i])
            for name, t in layer.ffn.named_parameters():
                put(t, body["ffn"][name][i])
    return model
