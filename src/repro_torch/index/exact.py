"""Exact (flat) kNN index on the fused `l2_topk` kernel (port of
`repro.index.exact`, static catalog).  On the card the query always runs
the kernel; CPU tensors take its plain version."""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.index.base import arrays_bytes, check_finite_queries
from repro_torch.kernels import ops


class FlatIndex:
    """Brute-force index: recall 1, exact distances."""

    exact_distances = True  # query() distances need no re-rank

    def __init__(self, embeddings, device=None):
        self.device = resolve_device(device)
        self.embeddings = torch.atleast_2d(torch.as_tensor(
            embeddings, dtype=torch.float32)).to(self.device).contiguous()

    @property
    def n(self) -> int:
        return int(self.embeddings.shape[0])

    def memory_bytes(self) -> int:
        return arrays_bytes(self.embeddings)

    def query(self, q: torch.Tensor, k: int):
        q = torch.atleast_2d(q)
        check_finite_queries(q, "FlatIndex.query")
        return ops.topk_l2(q.contiguous(), self.embeddings, k)
