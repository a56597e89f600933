"""Cost model of the paper (Sec. II / IV-A).  Port of `repro.core.costs`.

Objects and requests are embeddings in R^d; the dissimilarity cost is a
distance between them (squared Euclidean by default) and fetching an
object from the remote server adds c_f.  Every object has a local copy
(cost c_d) and a remote copy (cost c_d + c_f) in the augmented catalog.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops

# Finite stand-in for +inf so that cost differences never produce NaNs
# (1e9 is exact in float32).
BIG_COST = 1e9


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Dissimilarity + fetching cost specification."""

    c_f: float
    metric: str = "sqeuclidean"  # 'sqeuclidean' | 'euclidean' | 'ip'

    def dissimilarity(self, queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
        return pairwise_dissimilarity(queries, points, self.metric)


def pairwise_dissimilarity(queries: torch.Tensor, points: torch.Tensor,
                           metric: str = "sqeuclidean") -> torch.Tensor:
    """(Q, d) x (N, d) -> (Q, N) dissimilarity matrix.

    The squared-L2 metrics go through the `pairwise_l2` kernel (its plain
    version on CPU tensors); 'ip' is a plain matrix product."""
    queries = torch.atleast_2d(queries)
    if metric == "ip":
        return -(queries @ points.T)
    if metric not in ("sqeuclidean", "euclidean"):
        raise ValueError(f"unknown metric {metric!r}")
    sq = ops.pairwise_l2(queries, points)
    return torch.sqrt(sq) if metric == "euclidean" else sq


def calibrate_fetch_cost(catalog, *, kth: int = 50, sample: int = 512,
                         idx=None, generator: torch.Generator | None = None,
                         device=None) -> float:
    """c_f := average distance of the `kth` closest neighbour in the catalog.

    The paper's Sec. V-C construction, estimated over a sample of catalog
    points.  `idx` gives the sample's row indices (the reference draws
    them with `jax.random.choice(PRNGKey(seed), n, (sample,),
    replace=False)`); without it they are drawn without replacement from
    `generator` (a fresh CPU generator seeded 0 by default).  The
    neighbour search goes through the fused `l2_topk` kernel, so the
    (sample, N) distance matrix is never materialised on the card."""
    device = resolve_device(device)
    catalog = torch.as_tensor(catalog, dtype=torch.float32).to(device).contiguous()
    n = catalog.shape[0]
    if idx is None:
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        idx = torch.randperm(n, generator=gen, device=gen.device)[:min(sample, n)]
    idx = torch.as_tensor(idx, dtype=torch.long).to(device)
    # kth + 1 because the point itself is at distance 0
    d, _ = ops.topk_l2(catalog[idx].contiguous(), catalog, kth + 1)
    return float(torch.mean(d[:, kth]))
