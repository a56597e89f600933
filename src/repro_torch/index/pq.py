"""Product quantization codec + IVF-PQ index (port of `repro.index.pq`):
the paper's remote-catalog index, ~30 bytes an object à la FAISS IVFPQ
(Sec. III).

A query probes the coarse quantizer (`pairwise_l2`), builds the
per-subspace distance tables (one `pairwise_l2_batched` launch), takes
the stable top-`refine·k` shortlist of the probed rows by ADC in one
list-major `pq_adc_lists` launch over the codes stored list by list, and
re-ranks it exactly through the fused `ivf_scan` kernel.  Codes are uint8
(the reference holds int32), so the byte counts here are the port's own.

Mutable catalog: `add` encodes the new rows with the frozen codebooks,
writes their codes into the (capacity, M) slab and into the list-major
copy at their (list, column), and appends their ids to the lists (a
column doubling lays the list-major copy out again); `remove` tombstones
(the shortlist folds dead ids to -1 slots through `valid`); `refresh`
re-trains the quantizer and the codebooks over the live rows and
re-encodes them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.index.base import arrays_bytes, check_finite_queries, grow_rows, run_device
from repro_torch.index.ivf import IVFFlatIndex, remap_table
from repro_torch.index.kmeans import kmeans
from repro_torch.kernels import ops

COARSE_ITERS = 12  # the reference trains its coarse quantizer this long
ENCODE_ROWS = 131072  # rows a launch when encoding


def default_pq_init_fn(seed: int, m: int):
    """`pq_init_fn(n, ksub) -> (m, ksub)`: each subspace's initial centroid
    rows, from one CPU generator seeded with `seed` (the same on every
    device)."""

    def pq_init_fn(n: int, ksub: int):
        gen = torch.Generator().manual_seed(seed)
        return torch.stack([torch.randperm(n, generator=gen)[:ksub] for _ in range(m)])

    return pq_init_fn


class PQCodec:
    """M subspaces x 2**nbits-centroid codebooks (m, ksub, dsub)."""

    def __init__(self, codebooks: torch.Tensor):
        self.codebooks = torch.as_tensor(codebooks, dtype=torch.float32).contiguous()
        self.m, self.ksub, self.dsub = self.codebooks.shape
        if self.ksub > 256:
            raise ValueError(f"PQ: {self.ksub} centroids a subspace do not fit "
                             f"uint8 codes")

    @classmethod
    def train(cls, data: torch.Tensor, m: int = 8, nbits: int = 8,
              train_iters: int = 12, seed: int = 0, *, init_idx=None) -> "PQCodec":
        """Codebooks from (n, d) data: one k-means of ksub = min(2**nbits,
        n) centroids per subspace, padded to 2**nbits by repeating centroid
        0, as the reference does.  `init_idx` (m, ksub) gives each
        subspace's initial centroid rows (the reference draws them with
        `jax.random.choice` from `split(PRNGKey(seed), m)`); without it
        they are drawn from a CPU generator seeded with `seed`."""
        n, d = data.shape
        if d % m:
            raise ValueError(f"PQ: dimension {d} does not divide into {m} subspaces")
        if not 1 <= nbits <= 8:
            raise ValueError(f"PQ: nbits = {nbits}; codes are uint8 (1 to 8 bits)")
        dsub, full = d // m, 2 ** nbits
        ksub = min(full, n)
        if init_idx is None:
            init_idx = default_pq_init_fn(seed, m)(n, ksub)
        books = []
        for mi in range(m):
            sub = data[:, mi * dsub:(mi + 1) * dsub].contiguous()
            cents, _ = kmeans(sub, ksub, train_iters, init_idx=init_idx[mi])
            if ksub < full:  # pad tiny training sets
                cents = torch.cat([cents, cents[:1].expand(full - ksub, -1)])
            books.append(cents)
        return cls(torch.stack(books))

    def _distances(self, x: torch.Tensor) -> torch.Tensor:
        """(n, d) -> (n, m, ksub): each subspace of x against its codebook,
        one `pairwise_l2_batched` launch over the (m, n, dsub) view."""
        x = x.contiguous()
        view = x.view(x.shape[0], self.m, self.dsub).transpose(0, 1)
        return ops.pairwise_l2_batched(view, self.codebooks)

    def encode(self, data: torch.Tensor) -> torch.Tensor:
        """(n, d) -> (n, m) uint8 codes: the nearest centroid of each
        subspace (the first on ties, as jnp.argmin), ENCODE_ROWS rows a
        launch (their (rows, m, ksub) tables stay under 1 GB)."""
        codes = [torch.argmin(self._distances(data[i:i + ENCODE_ROWS]), dim=2)
                 for i in range(0, max(data.shape[0], 1), ENCODE_ROWS)]
        return torch.cat(codes).to(torch.uint8).contiguous()

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """(n, m) codes -> (n, d) reconstructed rows."""
        codes = codes.long()
        return torch.cat([self.codebooks[mi][codes[:, mi]] for mi in range(self.m)],
                         dim=1)

    def adc_lut(self, q: torch.Tensor) -> torch.Tensor:
        """(B, d) -> (B, m, ksub) per-subspace squared distances, in one
        `pairwise_l2_batched` launch (the reference vmaps over subspaces)."""
        return self._distances(q)


class IVFPQIndex(IVFFlatIndex):
    """Coarse IVF + PQ-coded storage + optional exact refine.

    With `refine > 1` the final top-k is re-ranked exactly (distances are
    exact); otherwise `query` returns ADC distances and the candidate
    builder re-ranks downstream."""

    # answer-cache capability flags, as the reference sets them: the ADC
    # shortlist is cut by approximate distance, so a mutation anywhere can
    # move its boundary (the answer-cache tier itself is ROADMAP A9)
    answer_unstable_add = True
    answer_unstable_remove = True

    def __init__(self, embeddings, nlist: int = 64, nprobe: int = 8, m: int = 8,
                 refine: int = 4, seed: int = 0, *, centroids=None,
                 invlists=None, codebooks=None, codes=None, init_idx=None,
                 pq_init_idx=None, init_fn=None, pq_init_fn=None, device=None):
        """Train the coarse quantizer (12 k-means iterations) and the
        codebooks over `embeddings`, and encode them; or take all four
        prebuilt structures (`codes` (capacity, m)) — how a reference-built
        index is loaded.  Initial rows: `init_idx` / `pq_init_idx` (m,
        ksub) for the first build, `init_fn(n, k)` / `pq_init_fn(n, ksub)`
        for every build (refresh and compaction too), by default drawn
        from CPU generators seeded with `seed` / `seed + 1` (the reference
        draws with `PRNGKey(seed)` and `split(PRNGKey(seed + 1), m)`)."""
        prebuilt = [a is not None for a in (centroids, invlists, codebooks, codes)]
        if any(prebuilt) and not all(prebuilt):
            raise ValueError("pass centroids, invlists, codebooks and codes "
                             "together, or none of them")
        self.m, self.refine = m, refine
        self.exact_distances = bool(refine and refine > 1)
        self.pq_init_fn = (pq_init_fn if pq_init_fn is not None
                           else default_pq_init_fn(seed + 1, m))
        self._pq_first = pq_init_idx  # the first build's codebook rows
        self._pq_loaded = None if codebooks is None else (codebooks, codes)
        super().__init__(embeddings, nlist, nprobe, COARSE_ITERS, seed,
                         centroids=centroids, invlists=invlists, init_idx=init_idx,
                         init_fn=init_fn, device=device)

    def _compute_structures(self, init_idx=None):
        """(Re-)train the quantizer and the codebooks over the live rows and
        encode them; ids stay slab ids.  Pure, as the IVF's."""
        live = self.live_rows()
        emb_live = self._live_embeddings(live)
        centroids, table = self._train_coarse(emb_live, self.train_iters, init_idx)
        if len(live) != self.capacity:
            table = remap_table(table, live)
        n_live = emb_live.shape[0]
        pq_init, self._pq_first = self._pq_first, None
        if pq_init is None:
            pq_init = self.pq_init_fn(n_live, min(256, n_live))
        codec = PQCodec.train(emb_live, self.m, seed=self.seed + 1, init_idx=pq_init)
        codes = torch.zeros((self.capacity, self.m), dtype=torch.uint8, device=self.device)
        codes[torch.from_numpy(live).to(self.device)] = codec.encode(emb_live)
        return centroids, table, codec, codes

    def _loaded_structures(self, centroids, invlists):
        codebooks, codes = self._pq_loaded
        self._pq_loaded = None
        codec = PQCodec(torch.as_tensor(np.asarray(codebooks, np.float32)).to(self.device))
        codes = np.asarray(codes)
        if codes.min() < 0 or codes.max() >= codec.ksub:
            raise ValueError("PQ codes outside [0, ksub)")
        if codes.shape != (self.capacity, codec.m):
            raise ValueError(f"PQ codes {codes.shape} do not match {self.capacity} rows "
                             f"x {codec.m} subspaces")
        codes = torch.as_tensor(codes.astype(np.uint8)).to(self.device).contiguous()
        return super()._loaded_structures(centroids, invlists) + (codec, codes)

    def _install_structures(self, structures) -> None:
        super()._install_structures(structures)
        self.codec, self.codes = structures[2:]
        # the code rows list-major: a probed list's rows are contiguous for
        # the shortlist's scan (the (capacity, M) codes stay for decode and
        # the dense scan)
        self.codes_lists = ops.codes_by_list(self.codes, self.invlists)

    def add(self, vectors) -> np.ndarray:
        """Encode-on-insert with the frozen codebooks, then append to the
        (stale-centroid) lists; each new code row is written into the
        (capacity, M) slab and at its (list, column) of the list-major
        copy, in place."""
        vectors = torch.atleast_2d(torch.as_tensor(vectors, dtype=torch.float32)).to(
            self.device)
        ids = self._append_rows(vectors)
        if self.codes.shape[0] < self.capacity:  # the slab grew
            self.codes = grow_rows(self.codes, self.capacity)
        new = self.codec.encode(vectors)
        start = int(ids[0])
        run_device(lambda c, v: c[start:start + v.shape[0]].copy_(v), self.codes, new)
        cols = self.invlists.shape[1]
        rows, pos = self._append_to_lists(vectors, ids)
        if self.invlists.shape[1] != cols:
            # the table's columns doubled: the list-major copy follows, with
            # its column count even for the kernel's 16-byte loads
            cap = self.invlists.shape[1]
            grown = torch.zeros((self.nlist, cap + cap % 2, self.m), dtype=torch.uint8,
                                device=self.device)
            grown[:, :self.codes_lists.shape[1]] = self.codes_lists
            self.codes_lists = grown
        run_device(lambda cl, r, p, v: cl.index_put_((r, p), v), self.codes_lists, rows,
                   pos, new)
        return ids

    def memory_bytes(self) -> int:
        """Everything resident at query time: the float32 catalog (the
        refine re-rank gathers from it) plus the PQ structures, the
        list-major code slab included."""
        return super().memory_bytes() + arrays_bytes(self.codes, self.codes_lists,
                                                     self.codec.codebooks)

    def compressed_bytes(self) -> int:
        """PQ-only footprint (codes + codebooks + coarse layer): what a
        deployment without the float32 catalog (refine off, re-rank
        elsewhere) would hold."""
        return arrays_bytes(self.codes, self.codec.codebooks, self.centroids,
                            self.invlists)

    def shortlist(self, q: torch.Tensor, k: int):
        """(ADC distances, ids), each (B, kk): the stable top kk of the
        probed rows by ADC, kk = refine * k with the exact re-rank (k
        without), at most the probed slots; ids -1 where they ran out.  One
        `pq_shortlist_lists` call: on the card a single list-major launch
        and the merge of its partials.  Tombstoned rows are folded to -1
        slots through `valid` once any row has died, as the reference
        masks its candidates before the ADC (so the re-rank needs no
        mask)."""
        probe = self.probe_lists(q)
        kk = min(self.refine * k if self.exact_distances else k,
                 probe.shape[1] * self.invlists.shape[1])
        return ops.pq_shortlist_lists(self.codec.adc_lut(q), self.codes_lists, self.invlists,
                                      probe, kk, valid=self.valid if self.masked else None,
                                      lens=self.lens)

    def query(self, q: torch.Tensor, k: int):
        q = torch.atleast_2d(q).contiguous()
        check_finite_queries(q, "IVFPQIndex.query")
        vals, ids = self.shortlist(q, k)
        if self.exact_distances:
            # exact re-rank of the ADC shortlist through the fused scan
            return ops.ivf_scan_topk(q, self.embeddings, ids.contiguous(), k)
        kk = ids.shape[1]
        if kk < k:  # fewer probed slots than k: underflow slots
            b = ids.shape[0]
            ids = torch.cat([ids, ids.new_full((b, k - kk), -1)], dim=1)
            vals = torch.cat([vals, vals.new_full((b, k - kk), float("inf"))], dim=1)
        return vals, ids
