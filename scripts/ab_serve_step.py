#!/usr/bin/env python3
"""Serving-step time of two trees of the PyTorch/CUDA port, interleaved.

    python3 scripts/ab_serve_step.py --tree A=path/to/parent --tree B=. \
        [--index flat] [--batch 8 64] [--order ABBAABBA]

Each tree is a checkout of this repository; its `src/repro_torch` is
imported afresh (the other tree's modules are dropped from `sys.modules`)
before each of its runs, so both run in one process on one card.  A run is
chip_smoke.py's slice run: `AcaiCache.serve_update_batch` over the 2048
sift-like requests of the 1M x 128 configuration (with chip_smoke.py's IVF
and IVF-PQ settings; each run builds its tree's index anew, outside the
timer), for each batch size, the wall time between two
`torch.cuda.synchronize()`.  Each tree first serves
one warm-up run (which builds its kernels).  Prints one line per run and the
median µs/request per tree and batch size.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

N, D, T = 1_000_000, 128, 2048
H, K, C_REMOTE, C_LOCAL = 400, 10, 64, 16  # chip_smoke.py's slice
# chip_smoke.py's index settings (IVF_FULL, IVFPQ_FULL); other backends
# take the registry's defaults
SPECS = {"ivf": {"nlist": 256, "nprobe": 16, "train_iters": 4},
         "ivfpq": {"nlist": 256, "nprobe": 16, "m": 8, "refine": 4}}


_SRCS: set[str] = set()  # the trees' src directories


def _use(src: Path):
    """Import the tree's repro_torch, dropping any other tree's."""
    for name in [m for m in sys.modules if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path[:] = [str(src)] + [p for p in sys.path if p not in _SRCS]
    from repro_torch.core import oma, policy
    from repro_torch.core.costs import calibrate_fetch_cost
    from repro_torch.index.base import IndexSpec
    return oma, policy, calibrate_fetch_cost, IndexSpec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=PATH of a checkout; give two")
    ap.add_argument("--index", default="flat")
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 64])
    ap.add_argument("--order", default="ABBAABBA")
    args = ap.parse_args()
    trees = {name: Path(path).resolve() for name, path in (t.split("=", 1) for t in args.tree)}
    _SRCS.update(str(p / "src") for p in trees.values())

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_serve_step: no CUDA device", file=sys.stderr)
        return 3
    dev = "cuda"
    state = {}

    def config(oma, policy, IndexSpec, c_f):  # of the tree imported last
        return policy.AcaiConfig(h=H, k=K, c_f=c_f, c_remote=C_REMOTE, c_local=C_LOCAL,
                                 oma=oma.OMAConfig(eta=0.05 / c_f),
                                 index=IndexSpec(args.index, SPECS.get(args.index, {})))

    for name in dict.fromkeys(args.order):  # set-up and warm-up, tree by tree
        oma, policy, calibrate_fetch_cost, IndexSpec = _use(trees[name] / "src")
        from repro_torch.core import trace
        cat, reqs, _ = trace.sift_like(n=N, d=D, t=T, seed=0)
        c_f = calibrate_fetch_cost(cat, kth=50, device=dev)
        state[name] = (cat, torch.from_numpy(reqs).to(dev), c_f,
                       policy.init_state(N, config(oma, policy, IndexSpec, c_f), seed=0,
                                         device=dev))
    times = {(name, b): [] for name in state for b in args.batch}

    def run(name, b, requests):
        oma, policy, _, IndexSpec = _use(trees[name] / "src")
        cat, reqs, c_f, s0 = state[name]
        cfg = config(oma, policy, IndexSpec, c_f)
        cache = policy.AcaiCache(cat, cfg, device=dev, state=policy.copy_state(s0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gains = [cache.serve_update_batch(reqs[i:i + b]).gain_int
                 for i in range(0, requests, b)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return dt / requests * 1e6, cache.normalized_gain(float(torch.cat(gains).sum()),
                                                          requests)

    for name in state:
        for b in args.batch:
            run(name, b, min(8 * b, T))
    for i, name in enumerate(args.order):
        for b in args.batch:
            us, nag = run(name, b, T)
            times[name, b].append(us)
            print(f"run {i} tree {name} {args.index} B={b}: us/request={us} NAG={nag}",
                  flush=True)
    for (name, b), v in times.items():
        print(f"median tree {name} ({trees[name]}) {args.index} B={b}: "
              f"us/request={statistics.median(v)} over {len(v)} runs {np.round(v, 1).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
