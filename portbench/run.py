"""The benchmark of the PyTorch and CUDA port (`src/repro_torch`): one run of one
cell, one JSON line of results.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (`BENCHMARK.json`'s `workloads`) names a configuration and a
traffic mix.  The run makes the inputs from the seed, builds the system,
warms up every batch size its traffic uses, then serves for `--seconds`:
closed-loop mixes hand the system full batches back to back, open-loop mixes
every due request, up to the largest batch, once the previous step's results
are on the host.  Each batch goes in as a host array and its per-request
results come back to the host before its requests count as answered.

With `--trace 0` the result holds the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from torch.profiler over a stretch of
steps inside the window.  After the window the program's outputs at the
steps the seed picks are compared with the plain reference
(`portbench/reference.py`); `correct` says whether every number compared is
within its limit, and the numbers close the result line and standard error.

Needs as many CUDA cards as the cell asks for; exits 2 without them, and 3
if a JAX module (`jax`, `jaxlib`, `flax`, the JAX package `repro`) or the
JAX package's `benchmarks` is loaded once the window has closed.
"""

from __future__ import annotations

import os
import sys
import time

T_START = time.perf_counter()
os.environ.setdefault("OMP_NUM_THREADS", "4")

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
# the stream of the steps the check picks
_PICK_TAG = 9


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names, compared whole, among `names` (the
    loaded modules by default)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Ctx:
    """What a metric's reader reads: the run's records, and the trace."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _picked_steps(seed: int, check: dict, within: int) -> set:
    """The window's steps 0 and 1, and pairs of consecutive steps drawn from
    the seed, `check["steps"]` in all, below `within`.  Step 0 starts from
    y_1, x_1, which the check reads by itself, and the second step of each
    pair from a state the first one put out, so every state a picked step
    starts from is one the check also compares."""
    import numpy as np

    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), _PICK_TAG]))
    picked = set(range(min(2, within, check["steps"])))
    for r in rng.permutation(np.arange(2, max(within - 1, 2))):
        if len(picked) + 2 > check["steps"]:
            break
        picked |= {int(r), int(r) + 1}
    return picked


class Tracer:
    """Profiles two stretches of `steps` steps from step `skip` of the window:
    the first with the device's activity alone (what the per-layer metrics
    read: a host-side trace would slow the host and widen the idle gaps), the
    second with the host's operations too (what the host did in each gap)."""

    def __init__(self, skip: int, steps: int):
        self.skip, self.steps = skip, steps
        self.prof = None
        self.parts = []

    def before(self, step: int) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        if step in (self.skip, self.skip + self.steps):
            acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
            if step != self.skip or not acts:
                acts.append(ProfilerActivity.CPU)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.t0 = time.perf_counter()

    def after(self, step: int, records: list) -> None:
        if self.prof is not None and step in (self.skip + self.steps - 1,
                                              self.skip + 2 * self.steps - 1):
            _sync()
            self.parts.append((self.prof, time.perf_counter() - self.t0,
                               records[-self.steps:]))
            self.prof.stop()
            self.prof = None

    def warm(self) -> None:
        """Start and stop each kind of profile once, so that the profiler's
        own set-up falls outside the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
        for kinds in ([*acts], [*acts, ProfilerActivity.CPU]):
            if kinds:
                with profile(activities=kinds):
                    torch.ones(1, device="cuda" if acts else "cpu").add_(1)
                    _sync()

    @property
    def tracing(self) -> bool:
        return self.prof is not None


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def serve_closed(system, traf, seconds: float, keep: set, tracer, min_requests: int):
    """Full batches back to back for `seconds`, then on until `min_requests`
    are served.  Returns (records, gains, window requests, window seconds,
    non-finite results)."""
    import numpy as np
    import torch

    b, ids, total = traf.batch, traf.ids, traf.ids.shape[0]
    records, gains, bad = [], [], 0
    step = served = 0
    window_requests, window_end = 0, None
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds and served >= min_requests:
            break
        if tracer is not None:
            tracer.before(step)
        pos = np.arange(served, served + b) % total
        with torch.profiler.record_function("portbench.batch"):
            rs = system.catalog_host[ids[pos]]
        ts = time.perf_counter()
        out = system.serve(rs, keep=step in keep)
        te = time.perf_counter()
        gains.append(out["gain"])
        bad += int((~np.isfinite(out["gain"]) | ~np.isfinite(out["cost"])).sum())
        traced = tracer is not None and tracer.tracing
        records.append((ts - t0, te - t0, b, 0.0, rs if traced else None))
        if ts - t0 < seconds:
            window_requests += b
            window_end = te - t0
        if tracer is not None:
            tracer.after(step, records)
        step += 1
        served += b
    return records, np.concatenate(gains), window_requests, window_end, bad


def serve_open(system, traf, keep: set, tracer):
    """Every request due at a step's start, up to the largest batch, once the
    previous step's results are on the host.  Returns (records, latencies,
    non-finite results)."""
    import numpy as np
    import torch

    due, ids, n = traf.due_s, traf.ids, traf.due_s.shape[0]
    lat = np.empty(n)
    records, bad = [], 0
    i = step = 0
    t0 = time.perf_counter()
    while i < n:
        now = time.perf_counter() - t0
        if due[i] > now:
            if due[i] - now > 0.002:
                time.sleep(due[i] - now - 0.001)
            while time.perf_counter() - t0 < due[i]:
                pass
            now = time.perf_counter() - t0
        if tracer is not None:
            tracer.before(step)
        j = min(int(np.searchsorted(due, now, side="right")), i + traf.batch)
        with torch.profiler.record_function("portbench.batch"):
            rs = system.catalog_host[ids[i:j]]
        ts = time.perf_counter() - t0
        out = system.serve(rs, keep=step in keep)
        te = time.perf_counter() - t0
        bad += int((~np.isfinite(out["gain"]) | ~np.isfinite(out["cost"])).sum())
        lat[i:j] = te - due[i:j]
        traced = tracer is not None and tracer.tracing
        records.append((ts, te, j - i, float(np.mean(ts - due[i:j])),
                        rs if traced else None))
        if tracer is not None:
            tracer.after(step, records)
        i = j
        step += 1
    return records, lat, bad


def execute(spec, seed: int, seconds: float, trace: bool, device, t_start: float,
            control: bool = False):
    """One run of `spec`'s cell: the result line's dict.  With `control`
    (`portbench/control.py`, never the benchmark's own runs) it also holds,
    under "control", the numbers compared when the reference in TF32 takes
    the program's place."""
    import importlib

    import numpy as np
    import torch

    from portbench import bench, tracing, traffic

    system_mod = importlib.import_module(f"portbench.systems.{spec.config['system']}")
    phases = {"start_s": time.perf_counter() - t_start}
    system = system_mod.System(spec.config, seed, device)
    phases.update(system.phases)
    t = time.perf_counter()
    traf = traffic.make_traffic(spec.mix, system.catalog, seed, seconds,
                                spec.config["catalog"]["seed"])
    phases["traffic_s"] = time.perf_counter() - t
    t = time.perf_counter()
    closed = traf.due_s is None
    cell = spec.cellfile
    if closed:
        system.warm([traf.batch])
        within = cell["nag_prefix"] // traf.batch
    else:
        system.warm(sorted({traf.batch >> s for s in range(traf.batch.bit_length())},
                           reverse=True))
        within = cell["check"]["within_steps"]
    keep = _picked_steps(seed, cell["check"], within)
    tracer = None
    if trace:
        tracer = Tracer(cell["trace"]["skip_steps"], cell["trace"]["steps"])
        tracer.warm()
    if device.type == "cuda":
        torch.cuda.synchronize()
    phases["warm_s"] = time.perf_counter() - t
    # what set-up made lives on to the end: out of the collector's sight, a
    # full collection in the window scans only what the window made
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    ctx = Ctx(spec=spec, system=system, setup_s=setup_s)
    if closed:
        records, gains, wreq, wend, bad = serve_closed(
            system, traf, seconds, keep, tracer, cell["nag_prefix"])
        ctx.gains, ctx.window_requests, ctx.window_s = gains, wreq, wend
        ctx.nag_prefix = cell["nag_prefix"]
        attempted = wreq
    else:
        records, lat, bad = serve_open(system, traf, keep, tracer)
        ctx.latency_s = lat
        attempted = lat.shape[0]
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    ctx.trace = gaps = None
    if tracer is not None and tracer.parts:
        prof, window_s, ctx.trace_records = tracer.parts[0]
        ctx.trace = tracing.from_profile(prof, tracer.steps, window_s)
        if len(tracer.parts) > 1:
            gaps = tracing.from_profile(tracer.parts[1][0], tracer.steps,
                                        tracer.parts[1][1]).idle_gaps()
    system.release()
    checks = system.check(control=control)
    if control:
        checks, ctrl = checks
    limits = cell["limits"]
    metrics = {}
    for m in spec.metrics(traced=trace):
        value = bench.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(bad == 0 and all(checks[k] <= limits[k] for k in checks)),
              "attempted": int(attempted), "failed": int(bad), "metrics": metrics,
              "device": dev}
    if ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.device_ops(),
                               "idle_gaps": gaps or []}
    result["setup_phases"] = phases
    window = [r[1] - r[0] for r in records if r[0] < seconds]
    if window:
        q = np.percentile(window, [10, 50, 90]) * 1e3
        result["step_ms"] = {"count": len(window), "p10": q[0], "median": q[1], "p90": q[2]}
    if control:
        result["control"] = ctrl
        result["diag"] = system.diag
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]} for k in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import bench

    spec = bench.Spec(args.workload)
    chips = spec.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = execute(spec, args.seed, args.seconds, bool(args.trace), device, T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
