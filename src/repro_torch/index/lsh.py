"""Random-hyperplane LSH index, multi-table with dense padded buckets
(port of `repro.index.lsh`, static catalog).

The hyperplanes come from `np.random.default_rng(seed)` exactly as in the
reference, and the buckets are built in numpy, so both are bitwise the
reference's.  A query hashes the whole batch with one einsum, gathers the
(B, tables * cap) candidate table, turns cross-table repeats into -1
slots (a stable sort keeps each id's first occurrence) and hands the
table to the fused `ivf_scan` kernel, the one the IVF probe uses.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.index.base import arrays_bytes, check_finite_queries
from repro_torch.index.ivf import build_invlists
from repro_torch.kernels import ops


def build_buckets(planes: np.ndarray, emb: np.ndarray,
                  cap: int | None = None) -> np.ndarray:
    """(tables, 2**bits, cap) int32 bucket table, -1 padded: each bucket
    holds its ids in ascending order, at most `cap` of them (the fullest
    bucket's count without a cap), as the reference's row-by-row fill."""
    tables, bits, _ = planes.shape
    nb = 2 ** bits
    sig = np.einsum("tbd,nd->tnb", planes, emb) > 0      # bit j: sign of plane j
    codes = (sig * (1 << np.arange(bits))[None, None, :]).sum(-1)   # (t, n)
    if cap is None:
        cap = max(int(np.bincount(codes[t], minlength=nb).max())
                  for t in range(tables))
    cap = max(cap, 1)
    return np.stack([build_invlists(codes[t], nb, cap) for t in range(tables)])


def dedup_to_minus_one(cand: torch.Tensor) -> torch.Tensor:
    """Every repeat of an id in a row becomes -1; the first occurrence
    stays (a stable sort by id puts it first among its equals)."""
    sid, order = torch.sort(cand, dim=1, stable=True)
    dup_sorted = torch.cat([torch.zeros_like(sid[:, :1], dtype=torch.bool),
                            sid[:, 1:] == sid[:, :-1]], dim=1)
    dup = torch.zeros_like(dup_sorted).scatter_(1, order, dup_sorted)
    return torch.where(dup, torch.full_like(cand, -1), cand)


class LSHIndex:
    exact_distances = True  # candidates scored with exact L2

    def __init__(self, embeddings, tables: int = 8, bits: int = 10,
                 cap: int | None = None, seed: int = 0, *, planes=None,
                 buckets=None, device=None):
        """Draw the planes from `seed` and bucket the catalog, or take
        prebuilt `planes` (tables, bits, d) and `buckets` (tables,
        2**bits, cap; -1 pads) — how a reference-built index is loaded."""
        if (planes is None) != (buckets is None):
            raise ValueError("pass both planes and buckets, or neither")
        self.device = resolve_device(device)
        self.embeddings = torch.atleast_2d(torch.as_tensor(
            embeddings, dtype=torch.float32)).to(self.device).contiguous()
        if planes is None:
            rng = np.random.default_rng(seed)
            planes = rng.normal(size=(tables, bits, self.embeddings.shape[1]))
            planes = planes.astype(np.float32)
            buckets = build_buckets(planes, self.embeddings.cpu().numpy(), cap)
        self.planes = torch.as_tensor(np.asarray(planes, np.float32)).to(self.device)
        self.buckets = torch.as_tensor(np.asarray(buckets, np.int32)).to(
            self.device).contiguous()
        self.tables, self.bits = int(self.planes.shape[0]), int(self.planes.shape[1])
        self._weights = (1 << torch.arange(self.bits, device=self.device))

    @property
    def n(self) -> int:
        return int(self.embeddings.shape[0])

    def memory_bytes(self) -> int:
        return arrays_bytes(self.embeddings, self.buckets, self.planes)

    def query(self, q: torch.Tensor, k: int):
        q = torch.atleast_2d(q).contiguous()
        check_finite_queries(q, "LSHIndex.query")
        b = q.shape[0]
        sig = torch.einsum("tbd,nd->ntb", self.planes, q) > 0      # (B, t, bits)
        codes = (sig.long() * self._weights).sum(-1)               # (B, t)
        tab = torch.arange(self.tables, device=q.device)[None, :]
        cand = self.buckets[tab, codes].reshape(b, -1)             # (B, t*cap)
        return ops.ivf_scan_topk(q, self.embeddings,
                                 dedup_to_minus_one(cand).contiguous(), k)
