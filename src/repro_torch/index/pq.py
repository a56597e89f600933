"""Product quantization codec + IVF-PQ index (port of `repro.index.pq`,
static catalog): the paper's remote-catalog index, ~30 bytes an object
à la FAISS IVFPQ (Sec. III).

A query probes the coarse quantizer (`pairwise_l2`), builds the
per-subspace distance tables (one `pairwise_l2_batched` launch), takes
the stable top-`refine·k` shortlist of the probed rows by ADC in one
list-major `pq_adc_lists` launch over the codes stored list by list, and
re-ranks it exactly through the fused `ivf_scan` kernel.  Codes are uint8
(the reference holds int32), so the byte counts here are the port's own.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.index.base import arrays_bytes, check_finite_queries
from repro_torch.index.ivf import IVFFlatIndex
from repro_torch.index.kmeans import kmeans
from repro_torch.kernels import ops

COARSE_ITERS = 12  # the reference trains its coarse quantizer this long
ENCODE_ROWS = 131072  # rows a launch when encoding


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
            gen = torch.Generator().manual_seed(seed)
            init_idx = torch.stack([torch.randperm(n, generator=gen)[:ksub]
                                    for _ in range(m)])
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
                 pq_init_idx=None, device=None):
        """Train the coarse quantizer (12 k-means iterations, initial rows
        `init_idx` or drawn with `seed`) and the codebooks (initial rows
        `pq_init_idx` (m, ksub) or drawn with `seed + 1`) over
        `embeddings`, and encode them; or take all four prebuilt
        structures — how a reference-built index is loaded."""
        prebuilt = [a is not None for a in (centroids, invlists, codebooks, codes)]
        if any(prebuilt) and not all(prebuilt):
            raise ValueError("pass centroids, invlists, codebooks and codes "
                             "together, or none of them")
        super().__init__(embeddings, nlist, nprobe, COARSE_ITERS, seed,
                         centroids=centroids, invlists=invlists,
                         init_idx=init_idx, device=device)
        self.m, self.refine = m, refine
        self.exact_distances = bool(refine and refine > 1)
        if codebooks is None:
            self.codec = PQCodec.train(self.embeddings, m, seed=seed + 1,
                                       init_idx=pq_init_idx)
            self.codes = self.codec.encode(self.embeddings)
        else:
            self.codec = PQCodec(torch.as_tensor(
                np.asarray(codebooks, np.float32)).to(self.device))
            codes = np.asarray(codes)
            if codes.min() < 0 or codes.max() >= self.codec.ksub:
                raise ValueError("PQ codes outside [0, ksub)")
            self.codes = torch.as_tensor(codes.astype(np.uint8)).to(
                self.device).contiguous()
        if self.codes.shape != (self.n, self.codec.m):
            raise ValueError(f"PQ codes {tuple(self.codes.shape)} do not match "
                             f"{self.n} rows x {self.codec.m} subspaces")
        # the code rows list-major: a probed list's rows are contiguous for
        # the shortlist's scan (the (N, M) codes stay for decode and the
        # dense scan)
        self.codes_lists = ops.codes_by_list(self.codes, self.invlists)

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
        and the merge of its partials."""
        probe = self.probe_lists(q)
        kk = min(self.refine * k if self.exact_distances else k,
                 probe.shape[1] * self.invlists.shape[1])
        return ops.pq_shortlist_lists(self.codec.adc_lut(q), self.codes_lists, self.invlists,
                                      probe, kk, lens=self.lens)

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
