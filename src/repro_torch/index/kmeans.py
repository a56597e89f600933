"""Lloyd k-means (port of `repro.index.kmeans`), used to train the IVF
coarse quantizer.  The distance step runs on the `pairwise_l2` kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels import ops


def kmeans(data: torch.Tensor, k: int, iters: int = 12, *, init_idx=None,
           generator: torch.Generator | None = None):
    """Returns (centroids (k, d), assignments (n,) int64).

    The initial centroids are the rows `init_idx` (k distinct indices; the
    reference draws them with `jax.random.choice(key, n, (k,),
    replace=False)`); without it they are drawn from `generator`.  Cluster
    sums use `index_add_`, whose summation order differs from the
    reference's one-hot matmul (and varies run to run on CUDA), so
    centroids agree to float tolerance."""
    n = data.shape[0]
    if init_idx is None:
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        init_idx = torch.randperm(n, generator=gen, device=gen.device)[:k]
    init_idx = torch.as_tensor(init_idx, dtype=torch.long).to(data.device)
    cents = data[init_idx].contiguous()
    for _ in range(iters):
        # torch.argmin returns the first minimum, as jnp.argmin does
        assign = torch.argmin(ops.pairwise_l2(data, cents), dim=1)
        sums = torch.zeros_like(cents).index_add_(0, assign, data)
        counts = torch.bincount(assign, minlength=k).to(data.dtype)[:, None]
        new = sums / torch.clamp_min(counts, 1.0)
        # keep the old centroid for empty clusters
        cents = torch.where(counts > 0, new, cents).contiguous()
    assign = torch.argmin(ops.pairwise_l2(data, cents), dim=1)
    return cents, assign
