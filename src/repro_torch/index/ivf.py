"""IVF-Flat index: coarse k-means partition + exact scan of probed lists
(port of `repro.index.ivf`, static catalog).

Inverted lists are a dense (nlist, cap) id table padded with -1, so a
probe is one gather.  The coarse distances run on the `pairwise_l2`
kernel and the probed lists on the fused `ivf_scan` kernel, which gathers
the listed rows straight from the catalog in device memory.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.index.base import arrays_bytes, check_finite_queries
from repro_torch.index.kmeans import kmeans
from repro_torch.kernels import ops
from repro_torch.kernels.ref import smallest_k


def build_invlists(assign: np.ndarray, nlist: int, cap: int | None = None):
    """Dense padded inverted lists from an assignment vector: list a holds
    the ids assigned to it in ascending order, -1 after them; ids past
    `cap` in a list are dropped.  A stable argsort does in one pass what
    the reference's Python loop does id by id, with the same result."""
    assign = np.asarray(assign).astype(np.int64)
    counts = np.bincount(assign, minlength=nlist)
    cap = int(counts.max()) if cap is None else cap
    table = np.full((nlist, cap), -1, np.int32)
    order = np.argsort(assign, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    col = np.arange(assign.shape[0]) - starts[assign[order]]
    keep = col < cap
    table[assign[order][keep], col[keep]] = order[keep]
    return table


def _probe_table(q, centroids, invlists, nprobe: int):
    """(B, d) -> the (B, nprobe * cap) id table of the probed lists."""
    dc = ops.pairwise_l2(q, centroids)                          # (B, nlist)
    # stable: equal centroid distances probe the lower list, as lax.top_k
    probe = smallest_k(dc, nprobe)[1]
    return invlists[probe].reshape(q.shape[0], -1)


def _ivf_query(q, emb, centroids, invlists, k: int, nprobe: int):
    """(B, d) -> (dists (B, k), ids (B, k)); ids = -1 on underflow."""
    return ops.ivf_scan_topk(
        q, emb, _probe_table(q, centroids, invlists, nprobe), k)


class IVFFlatIndex:
    exact_distances = True  # probed lists are scanned with exact L2

    def __init__(self, embeddings, nlist: int = 64, nprobe: int = 8,
                 train_iters: int = 12, seed: int = 0, *, centroids=None,
                 invlists=None, init_idx=None, device=None):
        """Train the quantizer over `embeddings`, or take prebuilt
        `centroids` (nlist, d) and `invlists` (nlist, cap) — how a
        reference-built index is loaded.  `init_idx` gives k-means' initial
        centroid rows; without it they are drawn from a CPU generator
        seeded with `seed`."""
        self.device = resolve_device(device)
        self.embeddings = torch.atleast_2d(torch.as_tensor(
            embeddings, dtype=torch.float32)).to(self.device).contiguous()
        self.nprobe = nprobe
        if (centroids is None) != (invlists is None):
            raise ValueError("pass both centroids and invlists, or neither")
        if centroids is None:
            n = self.embeddings.shape[0]
            nlist = min(nlist, max(n, 1))
            if init_idx is None:
                gen = torch.Generator().manual_seed(seed)
                init_idx = torch.randperm(n, generator=gen)[:nlist]
            centroids, assign = kmeans(self.embeddings, nlist, train_iters,
                                       init_idx=init_idx)
            invlists = build_invlists(assign.cpu().numpy(), nlist)
        self.centroids = torch.as_tensor(
            centroids, dtype=torch.float32).to(self.device).contiguous()
        self.invlists = torch.as_tensor(
            np.asarray(invlists), dtype=torch.int32).to(self.device).contiguous()
        self.nlist = int(self.centroids.shape[0])

    @property
    def n(self) -> int:
        return int(self.embeddings.shape[0])

    def memory_bytes(self) -> int:
        return arrays_bytes(self.embeddings, self.centroids, self.invlists)

    def probe_table(self, q: torch.Tensor) -> torch.Tensor:
        """The (B, nprobe * cap) candidate-id table `query` scans, -1 = pad."""
        return _probe_table(torch.atleast_2d(q).contiguous(), self.centroids,
                            self.invlists, min(self.nprobe, self.nlist))

    def query(self, q: torch.Tensor, k: int):
        q = torch.atleast_2d(q).contiguous()
        check_finite_queries(q, "IVFFlatIndex.query")
        return _ivf_query(q, self.embeddings, self.centroids, self.invlists,
                          k, min(self.nprobe, self.nlist))
