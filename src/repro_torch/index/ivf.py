"""IVF-Flat index: coarse k-means partition + exact scan of probed lists
(port of `repro.index.ivf`).

Inverted lists are a dense (nlist, cap) id table padded with -1, with
each list's true length beside it (`lens`, on the device).  The coarse
distances run on the `pairwise_l2` kernel and the probed lists on the
list-major `ivf_scan_lists` kernel, which reads each probed list's rows
from the catalog in device memory once for all the batch's queries that
probe it.

Mutable catalog: `add` bins new rows by the nearest *existing* centroid
(one `pairwise_l2` launch) and appends them to their lists in place; a
full list doubles the table's columns.  `remove` tombstones rows (the
probe folds them into -1 slots through `valid`); `refresh` re-trains the
quantizer and rebuilds the lists over the live rows, ids unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.index.base import (MutableRows, arrays_bytes, check_finite_queries,
                                    default_init_fn, run_device)
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


def invlist_positions(cursor: np.ndarray, assign: np.ndarray) -> np.ndarray:
    """Destination column of each appended id in its list: the list's
    cursor plus the id's rank among the batch's earlier ids of that list.
    Advances `cursor` in place."""
    pos = np.empty(assign.shape[0], np.int32)
    for j, a in enumerate(assign):
        pos[j] = cursor[a]
        cursor[a] += 1
    return pos


def invlist_append(invlists: torch.Tensor, cursor: np.ndarray, assign: np.ndarray,
                   ids: np.ndarray):
    """Append `ids` to their assigned lists of the (nlist, cols) table, in
    place; a list that would overflow doubles the table's columns first
    (cols = max(2 cols, needed), the reference's schedule).  Returns (the
    table, the ids' (list, column) positions as int64 tensors on its
    device); `cursor` is advanced in place."""
    counts = np.bincount(assign, minlength=cursor.shape[0])
    need = int((cursor + counts).max())
    cols = invlists.shape[1]
    if need > cols:
        cols = max(2 * cols, need)
        grown = torch.full((invlists.shape[0], cols), -1, dtype=invlists.dtype,
                           device=invlists.device)
        grown[:, :invlists.shape[1]] = invlists
        invlists = grown
    pos = invlist_positions(cursor, assign)
    dev = invlists.device
    rows = torch.from_numpy(assign.astype(np.int64)).to(dev)
    cols_t = torch.from_numpy(pos.astype(np.int64)).to(dev)
    vals = torch.from_numpy(ids.astype(np.int32)).to(dev)
    run_device(lambda t, r, c, v: t.index_put_((r, c), v), invlists, rows, cols_t, vals)
    return invlists, (rows, cols_t)


def assign_lists(vecs: torch.Tensor, centroids: torch.Tensor) -> np.ndarray:
    """The nearest centroid of each row (the first on ties, as jnp.argmin),
    by one `pairwise_l2` launch; on the host."""
    return torch.argmin(ops.pairwise_l2(vecs.contiguous(), centroids), dim=1).cpu().numpy()


def remap_table(table: np.ndarray, live: np.ndarray) -> np.ndarray:
    """A table of local ids (-1 pads) over the live rows as slab ids."""
    return np.where(table >= 0, live[np.clip(table, 0, None)], -1).astype(np.int32)


class IVFFlatIndex(MutableRows):
    exact_distances = True  # probed lists are scanned with exact L2

    def __init__(self, embeddings, nlist: int = 64, nprobe: int = 8,
                 train_iters: int = 12, seed: int = 0, *, centroids=None,
                 invlists=None, init_idx=None, init_fn=None, device=None):
        """Train the quantizer over `embeddings`, or take prebuilt
        `centroids` (nlist, d) and `invlists` (nlist, cap) — how a
        reference-built index is loaded.  k-means' initial centroid rows
        are `init_idx` for the first build; `init_fn(n, k)` gives them for
        every build (refresh and compaction too; the reference draws them
        with `jax.random.choice(PRNGKey(seed), n, (k,), replace=False)`),
        by default drawn from a CPU generator seeded with `seed`."""
        self.device = resolve_device(device)
        self._init_rows(embeddings, self.device)
        self._nlist, self.nprobe = nlist, nprobe  # nlist: the lists asked for
        self.train_iters, self.seed = train_iters, seed
        self.init_fn = init_fn if init_fn is not None else default_init_fn(seed)
        if (centroids is None) != (invlists is None):
            raise ValueError("pass both centroids and invlists, or neither")
        if centroids is None:
            self._install_structures(self._compute_structures(init_idx))
        else:
            self._install_structures(self._loaded_structures(centroids, invlists))

    # -- structure (re)build ------------------------------------------------

    def _train_coarse(self, emb_live: torch.Tensor, iters: int, init_idx=None):
        """(centroids, local-id table) of a k-means over the live rows."""
        n_live = emb_live.shape[0]
        nlist = min(self._nlist, max(n_live, 1))
        if init_idx is None:
            init_idx = self.init_fn(n_live, nlist)
        centroids, assign = kmeans(emb_live, nlist, iters, init_idx=init_idx)
        return centroids, build_invlists(assign.cpu().numpy(), nlist)

    def _compute_structures(self, init_idx=None):
        """(Re-)train the quantizer and the lists over the live rows, in
        slab order, with the local ids remapped to slab ids: a refreshed
        index answers as a fresh build on the live rows.  Pure: the
        serving structures stay until `_install_structures`."""
        live = self.live_rows()
        centroids, table = self._train_coarse(self._live_embeddings(live),
                                              self.train_iters, init_idx)
        if len(live) != self.capacity:
            table = remap_table(table, live)
        return centroids, table

    def _loaded_structures(self, centroids, invlists):
        """The `_install_structures` bundle of prebuilt structures."""
        return (torch.as_tensor(np.asarray(centroids, np.float32)).to(self.device),
                np.asarray(invlists, np.int32))

    def _install_structures(self, structures) -> None:
        centroids, table = structures[:2]
        self.centroids = centroids.to(self.device).contiguous()
        self.nlist = int(self.centroids.shape[0])
        self.invlists = torch.from_numpy(np.ascontiguousarray(table, np.int32)).to(self.device)
        # lists are filled from column 0 with no holes (tombstones stay in
        # them), so a list's cursor is its count of ids and its length
        self._cursor = (table >= 0).sum(axis=1).astype(np.int32)
        # each list's true length, on the device: the list-major scan walks
        # no padding; appends update it in place
        self.lens = ops.invlist_lengths(self.invlists)

    # -- mutation -----------------------------------------------------------

    def _append_to_lists(self, vectors: torch.Tensor, ids: np.ndarray):
        """Bin the new rows by the current (possibly stale) quantizer and
        append them to their lists; returns their (list, column) positions."""
        assign = assign_lists(vectors, self.centroids)
        self.invlists, pos = invlist_append(self.invlists, self._cursor, assign, ids)
        run_device(lambda lens, c: lens.copy_(c), self.lens,
                   torch.from_numpy(self._cursor).to(self.device))
        return pos

    def add(self, vectors) -> np.ndarray:
        """Append rows and bin them by the current coarse quantizer, as
        FAISS adds: the quantizer drifts until the next refresh."""
        vectors = torch.atleast_2d(torch.as_tensor(vectors, dtype=torch.float32)).to(
            self.device)
        ids = self._append_rows(vectors)
        self._append_to_lists(vectors, ids)
        return ids

    # -- queries ------------------------------------------------------------

    def memory_bytes(self) -> int:
        return arrays_bytes(self.embeddings, self.centroids, self.invlists, self.valid)

    def probe_lists(self, q: torch.Tensor) -> torch.Tensor:
        """The (B, nprobe) int32 lists `query` scans, nearest centroid
        first (stable: equal centroid distances probe the lower list, as
        lax.top_k)."""
        dc = ops.pairwise_l2(torch.atleast_2d(q).contiguous(), self.centroids)
        return smallest_k(dc, min(self.nprobe, self.nlist))[1].to(torch.int32)

    def probe_table(self, q: torch.Tensor) -> torch.Tensor:
        """The (B, nprobe * cap) candidate-id table of the probed lists,
        -1 = pad: what `query` scans, in this order."""
        return ops.probed_table(self.invlists, self.probe_lists(q))

    def query(self, q: torch.Tensor, k: int):
        """(B, d) -> (dists (B, k), ids (B, k)); ids = -1 on underflow.
        Tombstoned rows are folded to -1 slots through `valid` once any
        row has died (the lists never name unused slab rows)."""
        q = torch.atleast_2d(q).contiguous()
        check_finite_queries(q, "IVFFlatIndex.query")
        return ops.ivf_scan_lists(q, self.embeddings, self.invlists, self.probe_lists(q),
                                  k, valid=self.valid if self.masked else None,
                                  lens=self.lens)
