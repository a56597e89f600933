"""The request process of the port's `amazon_like`, vectorised.  The rows
are split into `clusters` by the nearest of as many rows drawn from the data
set's seed; the clusters' logits take a Gaussian random walk of `sigma` a
request, from the mix's own `walk_seed` (the same in every run, as a recorded
drift is); `seed` draws each request's cluster from the walk's softmax
(Gumbel-max) and its row by Zipf(`zipf_a`) over the cluster's rows in id
order (inverse transform)."""

import numpy as np
import torch

from portbench import traffic


def draw(catalog: torch.Tensor, count: int, params: dict, seed: int,
         data_seed: int = 0, chunk: int = 1 << 20) -> torch.Tensor:
    dev, n, m = catalog.device, catalog.shape[0], params["clusters"]
    heads = catalog[torch.randperm(n, generator=traffic.generator(data_seed, traffic.CLUSTERS,
                                                                  dev),
                                   device=dev)[:m]]
    walk_gen = traffic.generator(params["walk_seed"], traffic.WALK, dev)
    gen = traffic.generator(seed, traffic.CLUSTERS, dev)
    cn = (heads * heads).sum(1)
    assign = torch.empty(n, dtype=torch.long, device=dev)
    for s in range(0, n, chunk):
        x = catalog[s:s + chunk]
        assign[s:s + chunk] = torch.argmin(cn[None, :] - 2.0 * (x @ heads.T), 1)
    a = assign.cpu().numpy()
    members = np.argsort(a, kind="stable")          # by cluster, ids ascending in each
    sizes = np.bincount(a, minlength=m)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    rank = np.arange(n) - np.repeat(starts, sizes)
    w = (rank + 1.0) ** -params["zipf_a"]
    cum = np.cumsum(w)
    before = np.repeat(np.concatenate([[0.0], cum[np.cumsum(sizes)[:-1] - 1]]), sizes)
    totals = np.repeat(np.add.reduceat(w, starts), sizes) if n else w
    key = np.repeat(np.arange(m, dtype=np.float64), sizes) + (cum - before) / totals
    last = np.cumsum(sizes)[sizes > 0] - 1
    key[last] = np.arange(m, dtype=np.float64)[sizes > 0] + 1.0
    key = torch.from_numpy(key).to(dev)
    members = torch.from_numpy(members).to(dev)
    logits = torch.randn(m, dtype=torch.float64, generator=walk_gen, device=dev)
    out = torch.empty(count, dtype=torch.long, device=dev)
    for s in range(0, count, chunk):
        c = min(chunk, count - s)
        walk = logits + torch.cumsum(
            torch.randn((c, m), dtype=torch.float64, generator=walk_gen, device=dev)
            * params["sigma"], 0)
        logits = walk[-1]
        u = torch.rand((c, m), dtype=torch.float64, generator=gen, device=dev)
        cluster = torch.argmax(walk - torch.log(-torch.log(u)), 1)   # Gumbel-max
        v = torch.rand(c, dtype=torch.float64, generator=gen, device=dev)
        pos = torch.searchsorted(key, cluster.double() + v)
        out[s:s + c] = members[torch.clamp_max(pos, n - 1)]
    return out
