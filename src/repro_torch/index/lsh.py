"""Random-hyperplane LSH index, multi-table with dense padded buckets
(port of `repro.index.lsh`).

The hyperplanes come from `np.random.default_rng(seed)` exactly as in the
reference, and the buckets are built in numpy, so both are bitwise the
reference's.  A query hashes the whole batch with one einsum, gathers the
(B, tables * cap) candidate table, turns cross-table repeats into -1
slots (a stable sort keeps each id's first occurrence) and hands the
table to the fused `ivf_scan` kernel, the one the IVF probe uses.

Mutable catalog: the hyperplanes never change, so `add` hashes new rows
(on the host, in numpy, as the reference) into the buckets a fresh build
would use and appends them in place; a full bucket doubles the table's
columns unless the cap is fixed, where the overflow is dropped (FAISS-LSH
truncation).  `remove` tombstones; `refresh` rebuilds the buckets over
the live rows.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.index.base import MutableRows, arrays_bytes, check_finite_queries, run_device
from repro_torch.index.ivf import build_invlists, remap_table
from repro_torch.kernels import ops


def bucket_codes(planes: np.ndarray, emb: np.ndarray) -> np.ndarray:
    """(tables, n) bucket of each row in each table: bit j is the sign of
    plane j (numpy, as the reference hashes on build and insert)."""
    bits = planes.shape[1]
    sig = np.einsum("tbd,nd->tnb", planes, emb) > 0
    return (sig * (1 << np.arange(bits))[None, None, :]).sum(-1)


def build_buckets(planes: np.ndarray, emb: np.ndarray,
                  cap: int | None = None) -> np.ndarray:
    """(tables, 2**bits, cap) int32 bucket table, -1 padded: each bucket
    holds its ids in ascending order, at most `cap` of them (the fullest
    bucket's count without a cap), as the reference's row-by-row fill."""
    tables, bits, _ = planes.shape
    nb = 2 ** bits
    codes = bucket_codes(planes, emb)                                 # (t, n)
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


class LSHIndex(MutableRows):
    exact_distances = True  # candidates scored with exact L2

    def __init__(self, embeddings, tables: int = 8, bits: int = 10,
                 cap: int | None = None, seed: int = 0, *, planes=None,
                 buckets=None, device=None):
        """Draw the planes from `seed` and bucket the catalog, or take
        prebuilt `planes` (tables, bits, d) and `buckets` (tables,
        2**bits, cap; -1 pads) — how a reference-built index is loaded.
        `cap` fixes the bucket width (overflow dropped on add)."""
        if (planes is None) != (buckets is None):
            raise ValueError("pass both planes and buckets, or neither")
        self.device = resolve_device(device)
        self._init_rows(embeddings, self.device)
        if planes is None:
            rng = np.random.default_rng(seed)
            planes = rng.normal(size=(tables, bits, self.embeddings.shape[1]))
        self._planes_np = np.asarray(planes, np.float32)
        self.planes = torch.as_tensor(self._planes_np).to(self.device)
        self.tables, self.bits = int(self.planes.shape[0]), int(self.planes.shape[1])
        self._fixed_cap = cap
        self._weights = (1 << torch.arange(self.bits, device=self.device))
        if buckets is None:
            self._build_structures()
        else:
            self._install_structures(np.asarray(buckets, np.int32))

    def _compute_structures(self):
        """The bucket table over the live rows (the hash never drifts; the
        rebuild drops tombstoned slots).  Pure."""
        live = self.live_rows()
        emb = self._live_embeddings(live).cpu().numpy()
        table = build_buckets(self._planes_np, emb, self._fixed_cap)
        return table if len(live) == self.capacity else remap_table(table, live)

    def _install_structures(self, table) -> None:
        self.buckets = torch.from_numpy(np.ascontiguousarray(table, np.int32)).to(self.device)
        # buckets fill from column 0 and entries are only ever appended, so
        # a bucket's cursor is its count of ids
        self._cursor = (table >= 0).sum(axis=-1).astype(np.int32)

    def add(self, vectors) -> np.ndarray:
        """Hash-and-append: exact LSH insertion (insert-time buckets are a
        fresh build's).  Without a fixed cap a full bucket doubles the
        table's columns (a reallocation); with one the overflow is dropped."""
        vectors = torch.atleast_2d(torch.as_tensor(vectors, dtype=torch.float32)).to(
            self.device)
        ids = self._append_rows(vectors)
        codes = bucket_codes(self._planes_np, vectors.cpu().numpy())      # (t, B)
        cap = self.buckets.shape[2]
        if self._fixed_cap is None:
            need = int(self._cursor.max()) + len(ids)  # a loose bound, the reference's
            if need > cap:
                cap = max(2 * cap, need)
                grown = torch.full(self.buckets.shape[:2] + (cap,), -1, dtype=torch.int32,
                                   device=self.device)
                grown[..., :self.buckets.shape[2]] = self.buckets
                self.buckets = grown
        where, vals = [], []
        for t in range(self.tables):
            for i, bb in zip(ids, codes[t]):
                c = self._cursor[t, bb]
                if c < cap:
                    where.append((t, int(bb), int(c)))
                    vals.append(int(i))
                    self._cursor[t, bb] = c + 1
        if where:
            idx = torch.tensor(where, dtype=torch.long, device=self.device).T
            v = torch.tensor(vals, dtype=torch.int32, device=self.device)
            run_device(lambda b, i, v: b.index_put_(tuple(i), v), self.buckets, idx, v)
        return ids

    def memory_bytes(self) -> int:
        return arrays_bytes(self.embeddings, self.buckets, self.planes, self.valid)

    def query(self, q: torch.Tensor, k: int):
        q = torch.atleast_2d(q).contiguous()
        check_finite_queries(q, "LSHIndex.query")
        b = q.shape[0]
        sig = torch.einsum("tbd,nd->ntb", self.planes, q) > 0      # (B, t, bits)
        codes = (sig.long() * self._weights).sum(-1)               # (B, t)
        tab = torch.arange(self.tables, device=q.device)[None, :]
        cand = self.buckets[tab, codes].reshape(b, -1)             # (B, t*cap)
        return ops.ivf_scan_topk(q, self.embeddings, dedup_to_minus_one(cand).contiguous(),
                                 k, valid=self.valid if self.masked else None)
