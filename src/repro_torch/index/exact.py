"""Exact (flat) kNN index on the fused `l2_topk` kernel (port of
`repro.index.exact`).  On the card the query always runs the kernel; CPU
tensors take its plain version.

Mutable catalog: the embedding table is a capacity slab with a tombstone
mask (`MutableRows`): `add` appends, `remove` flips the mask, `refresh`
rebuilds nothing (the masked scan is exact over the live rows).
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.index.base import MutableRows, arrays_bytes, check_finite_queries
from repro_torch.kernels import ops


class FlatIndex(MutableRows):
    """Brute-force index: recall 1, exact distances."""

    exact_distances = True  # query() distances need no re-rank

    def __init__(self, embeddings, device=None):
        self.device = resolve_device(device)
        self._init_rows(embeddings, self.device)

    def memory_bytes(self) -> int:
        return arrays_bytes(self.embeddings, self.valid)

    def query(self, q: torch.Tensor, k: int):
        q = torch.atleast_2d(q)
        check_finite_queries(q, "FlatIndex.query")
        # the kernel scans the whole capacity: the mask is needed once a
        # row has died or the slab has rows past the high-water mark (the
        # fresh build takes the unmasked scan)
        masked = self._live != self.capacity
        return ops.topk_l2(q.contiguous(), self.embeddings, k,
                           valid=self.valid if masked else None)
