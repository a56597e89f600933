#!/usr/bin/env python3
"""The host cost of the serving step's spans (`repro_torch.spans`), in ns.

    PYTHONPATH=src python3 scripts/span_cost.py [--n 200000] [--repeat 9]

Times `with span("serve"): pass` and `with wait("upload"): pass` inside an
open step, and an empty step (the copy of its record into the ring
included), first with no profiler and then under torch.profiler recording
the CPU's activity (where each also opens its `acai.<phase>` host range),
less the bare loop's cost.  Prints one JSON line:
for each case the fastest of `--repeat` rounds of `--n` uses and their
median, in ns a use, with the host's CPU model.  Runs on the CPU alone.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import platform
import statistics
import timeit

from torch.profiler import ProfilerActivity, profile

from repro_torch import spans

CASES = {"span": "with S: pass", "wait": "with W: pass", "step": "with R.step(): pass"}


def _cpu() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def measure(n: int, repeat: int) -> dict:
    rec = spans.Recorder(capacity=16)
    env = {"S": spans.span("serve"), "W": spans.wait("upload"), "R": rec}
    loop = timeit.repeat("pass", globals=env, number=n, repeat=repeat)
    out = {}
    for prof in (False, True):
        for case, stmt in CASES.items():
            # a span inside an open step; a step by itself
            outer = rec.step() if case != "step" else contextlib.nullcontext()
            if prof:
                with profile(activities=[ProfilerActivity.CPU]), outer:
                    t = timeit.repeat(stmt, globals=env, number=n // 10, repeat=repeat)
                t = [x * 10 for x in t]
            else:
                with outer:
                    t = timeit.repeat(stmt, globals=env, number=n, repeat=repeat)
            ns = [(x - min(loop)) / n * 1e9 for x in t]
            key = f"{case}_ns_{'profiler' if prof else 'no_profiler'}"
            out[key] = {"min": min(ns), "median": statistics.median(ns)}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--repeat", type=int, default=9)
    args = ap.parse_args()
    res = measure(args.n, args.repeat)
    res["cpu"] = _cpu()
    print(json.dumps(res))


if __name__ == "__main__":
    main()
