"""The benchmark's one general generator: a catalog, the requests for it and
their arrival times, as a traffic mix's file of parameters says: the
requests and their times from `--seed`, the catalog from the
configuration.

Each part comes from a kind found by name, so a new kind is a new file:

- the catalog, `catalogs/<distribution>.py`: `make(spec, device)`, the
  configuration's `catalog` block;
- the popularity, `popularity/<kind>.py`: `draw(catalog, count, params,
  seed, data_seed)`, the catalog row of each of `count` requests, in order;
- the arrivals, `arrivals/<kind>.py`: `schedule(mix, seed, seconds)`,
  (count, batch, due): how many requests to draw, the batch (every batch of
  a closed loop, the largest of an open one), and each request's due time
  from the start, or None for a closed loop.

A request is its row's embedding (no jitter).  A closed loop that serves
more than it drew starts the trace again.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import bench

# tags that keep each draw's stream apart from the others of one seed
CATALOG, POPULARITY, ARRIVALS, CLUSTERS, WALK = 1, 2, 3, 7, 8
# the same for the draws a system makes: rounding uniforms, c_f's sample rows,
# k-means' first centroids, the warm-up's uniforms
UNIFORMS, SAMPLE, INIT, WARM = 4, 5, 6, 104


def subseed(seed: int, tag: int) -> int:
    """A 63-bit seed for one draw of a run: any whole `seed`, one `tag`."""
    ss = np.random.SeedSequence([seed % (1 << 64), tag])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, tag: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, tag))


def make_catalog(spec: dict, device) -> torch.Tensor:
    """The configuration's data set, from its own `seed`: the same in every
    run, as a published data set is."""
    return bench.plugin("catalogs", spec["distribution"]).make(spec, device)


@dataclasses.dataclass
class Traffic:
    ids: np.ndarray               # (T,) int64 catalog row of each request, in order
    batch: int                    # closed loop: every batch; open loop: the largest
    due_s: np.ndarray | None      # open loop: each request's due time from the start


def make_traffic(mix: dict, catalog: torch.Tensor, seed: int, seconds: float,
                 data_seed: int = 0) -> Traffic:
    """The requests of a run: their order, rows and arrival times from `seed`;
    what is the data set's own (the drift's clusters) from `data_seed`."""
    pop = mix["popularity"]
    count, batch, due = bench.plugin("arrivals", mix["arrivals"]["kind"]).schedule(
        mix, seed, seconds)
    ids = bench.plugin("popularity", pop["kind"]).draw(catalog, count, pop, seed, data_seed)
    return Traffic(ids.cpu().numpy(), batch, due)
