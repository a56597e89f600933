"""NSW graph index: a fixed-width, fixed-step batched beam search over a
dense (N, degree) neighbour table (port of `repro.index.nsw`, static
catalog).

The graph is built in numpy exactly as the reference builds it (exact kNN
plus random long-range shortcuts), so it is bitwise the reference's.  The
entry points are the catalog rows nearest to k-means centroids.  The
search is plain PyTorch with no kernel of its own: every step expands the
`expand` best unexpanded beam entries of every query, scores their
neighbours by difference, drops repeated ids and keeps the best `beam`.
Every selection is a stable sort, so ties go to the lowest position as
`lax.top_k` sends them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.index.base import arrays_bytes, check_finite_queries
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
               expand: int):
    """(B, d) -> (dists (B, k), ids (B, k) int32); ids = -1 on underflow."""
    b = q.shape[0]
    deg = graph.shape[1]
    inf = float("inf")
    nentry = entry_points.shape[0]
    seeds = entry_points[torch.arange(beam, device=q.device) % nentry].long()
    ids = seeds[None, :].expand(b, beam)
    # seeds past the entry points repeat them: never expand them
    dup0 = torch.arange(beam, device=q.device) >= nentry
    dist = torch.where(dup0[None, :], inf, _sq_dist(emb, ids, q))
    exp = dup0[None, :].expand(b, beam)
    for _ in range(steps):
        sel = smallest_k(torch.where(exp, inf, dist), expand)[1]   # (B, e)
        exp = exp.scatter(1, sel, True)
        nbrs = graph[torch.gather(ids, 1, sel)].reshape(b, expand * deg).long()
        all_ids = torch.cat([ids, nbrs], dim=1)
        all_d = torch.cat([dist, _sq_dist(emb, nbrs, q)], dim=1)
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


class NSWIndex:
    exact_distances = True  # candidates scored with exact L2

    def __init__(self, embeddings, degree: int = 16, beam: int = 32,
                 steps: int = 12, expand: int = 2, seed: int = 0, *,
                 graph=None, entry_points=None, init_idx=None, device=None):
        """Build the graph (numpy, seeded with `seed`) and the entry
        points: the catalog rows nearest to the min(beam, n) centroids of
        a 12-iteration k-means whose initial rows are `init_idx` (the
        reference draws them with `jax.random.choice(PRNGKey(seed))`) or
        come from a CPU generator seeded with `seed`.  Or take a prebuilt
        `graph` (n, degree) and `entry_points` — how a reference-built
        index is loaded."""
        if (graph is None) != (entry_points is None):
            raise ValueError("pass both graph and entry_points, or neither")
        self.device = resolve_device(device)
        self.embeddings = torch.atleast_2d(torch.as_tensor(
            embeddings, dtype=torch.float32)).to(self.device).contiguous()
        self.beam, self.steps = beam, steps
        self.expand = max(1, min(expand, beam))
        if graph is None:
            n = self.embeddings.shape[0]
            graph = build_nsw_graph(self.embeddings.cpu().numpy(), degree, seed=seed)
            nentry = min(beam, n)
            if init_idx is None:
                gen = torch.Generator().manual_seed(seed)
                init_idx = torch.randperm(n, generator=gen)[:nentry]
            cents, _ = kmeans(self.embeddings, nentry, init_idx=init_idx)
            entry_points = torch.argmin(ops.pairwise_l2(cents, self.embeddings), dim=1)
        self.graph = torch.as_tensor(np.asarray(graph, np.int32)).to(
            self.device).contiguous()
        self.entry_points = torch.as_tensor(entry_points).to(
            device=self.device, dtype=torch.int32)
        self.degree = int(self.graph.shape[1])

    @property
    def n(self) -> int:
        return int(self.embeddings.shape[0])

    def memory_bytes(self) -> int:
        return arrays_bytes(self.embeddings, self.graph, self.entry_points)

    def query(self, q: torch.Tensor, k: int):
        q = torch.atleast_2d(q).contiguous()
        check_finite_queries(q, "NSWIndex.query")
        return _nsw_query(q, self.embeddings, self.graph, self.entry_points, k,
                          self.beam, self.steps, self.expand)
