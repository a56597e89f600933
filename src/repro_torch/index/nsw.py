"""NSW graph index: a fixed-width, fixed-step batched beam search over a
dense (N, degree) neighbour table (port of `repro.index.nsw`).

The graph is built in numpy exactly as the reference builds it (exact kNN
plus random long-range shortcuts), so it is bitwise the reference's.  The
entry points are the catalog rows nearest to k-means centroids.  The
search is plain PyTorch with no kernel of its own: every step expands the
`expand` best unexpanded beam entries of every query, scores their
neighbours by difference, drops repeated ids and keeps the best `beam`.
Every selection is a stable sort, so ties go to the lowest position as
`lax.top_k` sends them.

Mutable catalog: `add` is the classic incremental NSW insertion (the new
node's out-edges are its beam-search kNN over the graph as it stands plus
random shortcuts to live nodes; `_REV_LINKS` of its neighbours each give
one edge slot back), with the reference's numpy generator
(`default_rng(seed + 1)`), so the graph equals the reference's edge for
edge.  `remove` tombstones: dead nodes keep routing the beam but score
+inf; `refresh` rebuilds the graph and entry points over the live rows.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.index.base import (MutableRows, arrays_bytes, check_finite_queries,
                                    default_init_fn, grow_rows, run_device)
from repro_torch.index.kmeans import kmeans
from repro_torch.index.lsh import dedup_to_minus_one
from repro_torch.kernels import ops
from repro_torch.kernels.ref import smallest_k


def build_nsw_graph(emb: np.ndarray, degree: int = 16, shortcuts: int = 2,
                    seed: int = 0, chunk: int = 1024) -> np.ndarray:
    """(n, degree) int32: each row's knn = degree - shortcuts nearest rows
    (itself excluded) and `shortcuts` random rows; the reference's build."""
    n = emb.shape[0]
    rng = np.random.default_rng(seed)
    knn = min(degree - shortcuts, n - 1)
    graph = np.empty((n, degree), np.int32)
    cn = (emb ** 2).sum(1)
    for s in range(0, n, chunk):
        q = emb[s:s + chunk]
        d = (q ** 2).sum(1)[:, None] - 2 * q @ emb.T + cn[None]
        np.fill_diagonal(d[:, s:s + q.shape[0]], np.inf)
        part = np.argpartition(d, knn, axis=1)[:, :knn]
        graph[s:s + chunk, :knn] = part
    graph[:, knn:] = rng.integers(0, n, (n, degree - knn))
    return graph


def _sq_dist(emb: torch.Tensor, ids: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(B, W) ids -> (B, W) squared distances to each query, by difference."""
    diff = emb[ids] - q[:, None, :]
    return torch.sum(diff * diff, dim=-1)


def _nsw_query(q, emb, graph, entry_points, k: int, beam: int, steps: int,
               expand: int, valid=None):
    """(B, d) -> (dists (B, k), ids (B, k) int32); ids = -1 on underflow.
    With `valid`, dead nodes keep routing (their edges stay) but score
    +inf, so they are expanded last and never surface."""
    b = q.shape[0]
    deg = graph.shape[1]
    inf = float("inf")
    nentry = entry_points.shape[0]
    seeds = entry_points[torch.arange(beam, device=q.device) % nentry].long()
    ids = seeds[None, :].expand(b, beam)
    # seeds past the entry points repeat them: never expand them
    dup0 = torch.arange(beam, device=q.device) >= nentry
    dist = _sq_dist(emb, ids, q)
    if valid is not None:
        dist = torch.where(valid[seeds][None, :], dist, inf)
    dist = torch.where(dup0[None, :], inf, dist)
    exp = dup0[None, :].expand(b, beam)
    for _ in range(steps):
        sel = smallest_k(torch.where(exp, inf, dist), expand)[1]   # (B, e)
        exp = exp.scatter(1, sel, True)
        nbrs = graph[torch.gather(ids, 1, sel)].reshape(b, expand * deg).long()
        all_ids = torch.cat([ids, nbrs], dim=1)
        nd = _sq_dist(emb, nbrs, q)
        if valid is not None:
            nd = torch.where(valid[nbrs], nd, inf)
        all_d = torch.cat([dist, nd], dim=1)
        all_exp = torch.cat([exp, torch.zeros_like(nbrs, dtype=torch.bool)], dim=1)
        # a repeated id keeps its first occurrence; the rest go to +inf
        all_d = torch.where(dedup_to_minus_one(all_ids) < 0, inf, all_d)
        dist, pos = smallest_k(all_d, beam)
        ids = torch.gather(all_ids, 1, pos)
        exp = torch.gather(all_exp, 1, pos)
    # the beam holds at most `beam` candidates: k beyond it underflows
    kk = min(k, beam)
    out_d, pos = smallest_k(dist, kk)
    out_ids = torch.gather(ids, 1, pos)
    out_ids = torch.where(torch.isfinite(out_d), out_ids, torch.full_like(out_ids, -1))
    if kk < k:
        out_d = torch.cat([out_d, out_d.new_full((b, k - kk), inf)], dim=1)
        out_ids = torch.cat([out_ids, out_ids.new_full((b, k - kk), -1)], dim=1)
    return out_d, out_ids.to(torch.int32)


class NSWIndex(MutableRows):
    exact_distances = True  # candidates scored with exact L2
    # answer-cache capability flags, as the reference sets them: insertion
    # rewires existing nodes' edges and the first tombstone switches the
    # beam's masking on (`serve.answer_cache.CachedIndex` flushes then)
    answer_unstable_add = True
    answer_unstable_remove = True
    # how many of a new node's neighbours give one edge slot back to it
    _REV_LINKS = 2

    def __init__(self, embeddings, degree: int = 16, beam: int = 32,
                 steps: int = 12, expand: int = 2, seed: int = 0, *,
                 graph=None, entry_points=None, init_idx=None, init_fn=None,
                 device=None):
        """Build the graph (numpy, seeded with `seed`) and the entry
        points: the catalog rows nearest to the min(beam, n) centroids of
        a 12-iteration k-means whose initial rows are `init_idx` (first
        build) or `init_fn(n, k)` (every build; the reference draws them
        with `jax.random.choice(PRNGKey(seed))`), by default from a CPU
        generator seeded with `seed`.  Or take a prebuilt `graph`
        (capacity, degree) and `entry_points` — how a reference-built index
        is loaded."""
        if (graph is None) != (entry_points is None):
            raise ValueError("pass both graph and entry_points, or neither")
        self.device = resolve_device(device)
        self._init_rows(embeddings, self.device)
        self.beam, self.steps, self.degree = beam, steps, degree
        self.expand = max(1, min(expand, beam))
        self.seed = seed
        self.init_fn = init_fn if init_fn is not None else default_init_fn(seed)
        self._rng = np.random.default_rng(seed + 1)  # insertion randomness
        if graph is None:
            self._install_structures(self._compute_structures(init_idx))
        else:
            self._install_structures((np.asarray(graph, np.int32),
                                      torch.as_tensor(np.asarray(entry_points))))

    def _compute_structures(self, init_idx=None):
        """Graph and entry points over the live rows, ids remapped to slab
        rows (unused and dead rows get zero rows: unreachable).  Pure."""
        live = self.live_rows()
        emb_live = self._live_embeddings(live)
        graph_live = build_nsw_graph(emb_live.cpu().numpy(), self.degree, seed=self.seed)
        graph = np.zeros((self.capacity, self.degree), np.int32)
        graph[live] = live[graph_live]
        nentry = min(self.beam, len(live))
        if init_idx is None:
            init_idx = self.init_fn(len(live), nentry)
        cents, _ = kmeans(emb_live, nentry, init_idx=init_idx)
        near = torch.argmin(ops.pairwise_l2(cents, emb_live), dim=1).cpu().numpy()
        return graph, torch.from_numpy(live[near])

    def _install_structures(self, structures) -> None:
        graph, entry_points = structures
        self.graph = torch.from_numpy(np.ascontiguousarray(graph, np.int32)).to(self.device)
        self.entry_points = entry_points.to(device=self.device, dtype=torch.int32)
        self.degree = int(self.graph.shape[1])

    def add(self, vectors) -> np.ndarray:
        """Incremental insertion, one batch against the graph as it stands
        (the batch's nodes are not linked to each other): out-edges are the
        beam-search kNN plus random live shortcuts, and `_REV_LINKS`
        neighbours each give one slot back.  Rows are written in place."""
        vectors = torch.atleast_2d(torch.as_tensor(vectors, dtype=torch.float32)).to(
            self.device)
        live_before = self.live_rows()
        knn = min(self.degree - 2, max(len(live_before) - 1, 1))
        nbr = self.query(vectors, knn)[1].cpu().numpy()                 # (B, knn)
        ids = self._append_rows(vectors)
        if self.graph.shape[0] < self.capacity:  # the slab grew
            self.graph = grow_rows(self.graph, self.capacity)
        rows = np.zeros((len(ids), self.degree), np.int32)
        rev = {}  # reverse links, flat slot -> new node; a later write wins
        for row, (i, nb) in enumerate(zip(ids, nbr)):
            nb = nb[nb >= 0]
            if len(nb) == 0:  # the first node ever: self-loops
                rows[row] = i
                continue
            out = np.full((self.degree,), i, np.int32)
            out[:len(nb)] = nb
            n_short = self.degree - len(nb)
            if n_short > 0 and len(live_before):
                out[len(nb):] = self._rng.choice(live_before, size=n_short)
            rows[row] = out
            for j in nb[:self._REV_LINKS]:
                slot = int(self._rng.integers(self.degree))
                rev[int(j) * self.degree + slot] = int(i)
        start = int(ids[0])
        run_device(lambda g, r: g[start:start + r.shape[0]].copy_(r), self.graph,
                   torch.from_numpy(rows).to(self.device))
        if rev:
            flat = torch.tensor(list(rev), dtype=torch.long, device=self.device)
            vals = torch.tensor(list(rev.values()), dtype=torch.int32, device=self.device)
            run_device(lambda g, f, v: g.view(-1).index_copy_(0, f, v), self.graph, flat, vals)
        return ids

    def memory_bytes(self) -> int:
        return arrays_bytes(self.embeddings, self.graph, self.entry_points, self.valid)

    def query(self, q: torch.Tensor, k: int):
        q = torch.atleast_2d(q).contiguous()
        check_finite_queries(q, "NSWIndex.query")
        # dead nodes keep routing until a refresh, so the mask is on from
        # the first tombstone; rows past n_slots have no in-edges
        return _nsw_query(q, self.embeddings, self.graph, self.entry_points, k,
                          self.beam, self.steps, self.expand,
                          self.valid if self.masked else None)
