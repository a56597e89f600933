"""The readings the comparison's limits are set from, on the chip at a cell's
own size: for each seed, one run of the program (a short window; the steps
the check picks lie in the cell's NAG prefix or its `within_steps`), the
numbers compared for the program, and the same numbers for the control: the
plain reference with its distance products in TF32 put in the program's
place, at the same picked steps from the same states.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ... [--seconds 3]

Prints one JSON line a seed, and the largest program reading and the
smallest control reading of each number.  Needs a CUDA card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from portbench import bench, run

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = bench.Spec(args.workload)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = run.execute(spec, seed, args.seconds, False, device, t0, control=True)
        prog = {k: v["value"] for k, v in res["checks"].items()}
        rows.append((prog, res["control"]))
        print(json.dumps({"seed": seed, "program": prog, "control": res["control"],
                          "correct": res["correct"], "diag": res["diag"],
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    names = rows[0][0].keys()
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "program_max": {k: max(p[k] for p, _ in rows) for k in names},
                      "control_min": {k: min(c[k] for _, c in rows) for k in names}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
