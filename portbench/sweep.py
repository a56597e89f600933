"""The rate sweep behind an open-loop mix's `rate_rps`: the highest rate the
system sustains without a growing backlog, found once, on the chip.

    python3 portbench/sweep.py --workload <open-loop cell> --rates 40000 60000 ... \
        [--seconds 6] [--seed 1]

Builds the cell's system once, then offers each rate in turn for `--seconds`
(the mix's popularity and batching; the cell's `rate_rps` is not read) and
prints a JSON line a rate: the latency percentiles, the mean batch, and the
growth of the backlog (the mean latency of the last fifth of the requests
over that of the second fifth; about 1 where the queue holds steady).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import importlib

    import numpy as np
    import torch

    from portbench import bench, run, traffic

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = bench.Spec(args.workload)
    system = importlib.import_module(f"portbench.systems.{spec.config['system']}").System(
        spec.config, args.seed, device)
    batch = spec.mix["arrivals"]["max_batch"]
    system.warm(sorted({batch >> s for s in range(batch.bit_length())}, reverse=True))
    for i, rate in enumerate(args.rates):
        mix = copy.deepcopy(spec.mix)
        mix["arrivals"]["rate_rps"] = rate
        traf = traffic.make_traffic(mix, system.catalog, args.seed + i, args.seconds,
                                    spec.config["catalog"]["seed"])
        records, lat, bad = run.serve_open(system, traf, set(), None)
        n = lat.shape[0]
        fifth = max(n // 5, 1)
        print(json.dumps({
            "rate_rps": rate, "requests": n, "failed": bad,
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p95_ms": float(np.percentile(lat, 95) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "mean_batch": float(np.mean([r[2] for r in records])),
            "steps": len(records),
            "backlog_growth": float(np.mean(lat[-fifth:]) / np.mean(lat[fifth:2 * fifth])),
            "last_done_s": records[-1][1]}), flush=True)
    print(f"card: {torch.cuda.get_device_name(device)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
