"""Config-driven experiment harness: (TraceSpec x PolicySpec) grids (port
of `benchmarks/experiments.py`, the canonical cross-policy grid).

A grid names its traces, its policies and its sizes; `run_grid` generates
each trace once, precomputes ONE `ServerOracle` per trace (shared by every
baseline cell; its exact kNN scan is the `l2_topk` kernel on the card),
calibrates c_f, builds each policy through `build_policy`, replays it and
returns NAG / hit ratio / p50 step latency per (trace x policy) cell.

    PYTHONPATH=src python -m repro_torch.experiments [--device cpu]
    PYTHONPATH=src python -m repro_torch.experiments \\
        --from-bench BENCH_experiments.json [--device cpu] [--out PATH]

`--from-bench` replays each row of a reference results file with the
row's own policy dict (`PolicySpec.from_dict`) on the row's trace at the
file's n and t; a trace's c_f is the full-precision c_f of its acai row.
It prints each row's NAG beside the file's.  Without it, the `experiments`
grid runs with c_f calibrated by `calibrate_fetch_cost(kth=50,
sample=256)`.  `--out` writes the rows, with the card's name and power
limit, as JSON.  The reference's figure grids (fig1-fig8) are not ported
yet (ROADMAP A0d).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import subprocess
import sys
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import baselines as B
from repro_torch.core import policy_api as PA
from repro_torch.core import trace as T
from repro_torch.core.costs import CostModel, calibrate_fetch_cost
from repro_torch.core.policy_api import PolicySpec
from repro_torch.core.trace import TraceSpec
from repro_torch.kernels import ops

@dataclasses.dataclass(frozen=True)
class Grid:
    """One experiment: traces x policies at a given size.  `policies` is a
    tuple of PolicySpec or a callable (c_f, h, k, full) -> specs, so a grid
    can place calibrated values (C_theta = 1.5 c_f) in its cells;
    `summarize(rows) -> [(label, value)]` emits figure-level lines."""

    name: str
    desc: str
    traces: Tuple[TraceSpec, ...]
    policies: "Tuple[PolicySpec, ...] | Callable"
    h: int = 200
    k: int = 10
    full_h: int = 1000
    # c_f = average distance of the kth closest neighbour (Sec. V-C)
    cf_kths: Tuple[int, ...] = (50,)
    batch: int = 8
    summarize: Optional[Callable] = None

    def policy_specs(self, c_f: float, h: int, k: int, full: bool):
        if callable(self.policies):
            return tuple(self.policies(c_f, h, k, full))
        return self.policies


def sweep(name: str, base: dict = None, **param_lists) -> list:
    """Expand a cartesian parameter sweep into PolicySpecs:
    sweep("sim_lru", {"h": 200}, k_prime=[10, 20], c_theta=[1.0, 1.5])
    -> 4 specs."""
    base = dict(base or {})
    keys = sorted(param_lists)
    return [PolicySpec(name, {**base, **dict(zip(keys, combo))})
            for combo in itertools.product(*(param_lists[k] for k in keys))]


def _sizes(full: bool) -> dict:
    """The reference's sizes: reduced by default, the paper's at --full."""
    return dict(n=20000, t=30000) if full else dict(n=4000, t=4000)


def _emit(name: str, us_per_call: float, derived) -> None:
    """One CSV line `name,us_per_call,derived`, as the reference prints."""
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


# trace and oracle caches: every cell of a trace shares one generation and
# one oracle precompute
_TRACE_CACHE: Dict[tuple, tuple] = {}
_ORACLE_CACHE: Dict[tuple, "B.ServerOracle"] = {}


def _cache_key(tspec: TraceSpec, sz: dict) -> tuple:
    return (tspec, tuple(sorted(sz.items())))


def _get_trace(tspec: TraceSpec, sz: dict):
    key = _cache_key(tspec, sz)
    if key not in _TRACE_CACHE:
        if len(_TRACE_CACHE) >= 4:  # bound resident traces
            _TRACE_CACHE.pop(next(iter(_TRACE_CACHE)))
        catalog, reqs, _ids = T.build_trace(tspec, **sz)
        _TRACE_CACHE[key] = (catalog, reqs)
    return _TRACE_CACHE[key]


def _get_oracle(tspec: TraceSpec, sz: dict, catalog, reqs, kmax: int, device):
    key = _cache_key(tspec, sz) + (str(device),)
    oracle = _ORACLE_CACHE.get(key)
    if oracle is None or oracle.kmax < min(kmax, catalog.shape[0]):
        if len(_ORACLE_CACHE) >= 4:
            _ORACLE_CACHE.pop(next(iter(_ORACLE_CACHE)))
        oracle = B.ServerOracle(catalog, reqs, kmax=kmax, device=device)
        _ORACLE_CACHE[key] = oracle
    return oracle


def _calibrate(catalog, kth: int, device) -> float:
    return float(calibrate_fetch_cost(catalog, kth=min(kth, catalog.shape[0] - 1),
                                      sample=256, device=device))


def run_cell(grid_name: str, tspec: TraceSpec, spec: PolicySpec, catalog, reqs,
             oracle, c_f: float, kth: int, h: int, batch: int, device,
             prepare: Callable = None) -> dict:
    """Build one policy over the trace's shared oracle, replay the trace
    and return its row (the reference's row keys, and `nag_full`, the
    unrounded NAG).  `prepare(pol, spec)`, when given, returns the
    keyword arguments of the replay (a test injects AÇAI's state and
    uniforms there)."""
    pol = PA.build_policy(spec, catalog, CostModel(c_f=c_f), oracle=oracle, seed=0,
                          device=device)
    replay_kw = prepare(pol, spec) if prepare is not None else {}
    ts = np.arange(reqs.shape[0])
    t0 = time.perf_counter()
    res = PA.replay_trace(pol, reqs, ts, batch=batch, **replay_kw)
    wall = time.perf_counter() - t0
    tt = res["requests"]
    nag_curve = B.nag(res["gain"], pol.k, pol.c_f)
    occ = res["occupancy"]
    hh = spec.params.get("h", h)
    return {
        "grid": grid_name, "trace": tspec.to_dict(),
        "policy": spec.to_dict(), "label": spec.label,
        "requests": tt, "h": hh, "k": pol.k, "cf_kth": kth, "c_f": round(c_f, 5),
        "nag": round(float(nag_curve[-1]), 4),
        # time-to-90%-of-final NAG (the paper's reactivity metric)
        "t90": int(np.argmax(nag_curve >= 0.9 * nag_curve[-1])),
        "hit_ratio": round(float(res["hit"].mean()), 4),
        "local_share": round(float(res["served_local"].sum()) / (pol.k * tt), 4),
        "fetches_per_req": round(float(res["fetched"].mean()), 3),
        "occupancy_mean": round(float(occ.mean()), 1),
        "occupancy_max": float(occ.max()),
        "occupancy_p99_dev": round(float(np.percentile(np.abs(occ - hh), 99)) / hh, 4),
        "p50_step_us": round(res["p50_step_s"] * 1e6, 1),
        "us_per_request": round(wall / tt * 1e6, 2),
        "nag_full": float(nag_curve[-1]),
    }


def _emit_row(grid_name: str, row: dict, tag: str = "", extra: str = "") -> None:
    _emit(f"{grid_name}/{row['trace']['name']}/{tag}{row['label']}", row["us_per_request"],
         f"NAG={row['nag']:.4f};hit={row['hit_ratio']:.3f};"
         f"p50_step_us={row['p50_step_us']:.0f}{extra}")


def run_grid(grid: Grid, full: bool = False, sizes: dict = None, device=None,
             calibrate: Callable = None, prepare: Callable = None) -> list[dict]:
    """Run every (trace x policy) cell of a grid; returns the row dicts.

    Per trace: one generation, one ServerOracle precompute on `device`
    (kmax the largest k' any cell asks for, at least 128), one c_f per
    `grid.cf_kths` entry (`calibrate(catalog, kth)`, default
    `calibrate_fetch_cost(kth, sample=256)` on `device`).  `prepare` goes
    to `run_cell`."""
    device = resolve_device(device)
    sz = sizes or _sizes(full)
    calibrate = calibrate or (lambda cat, kth: _calibrate(cat, kth, device))
    rows = []
    for tspec in grid.traces:
        catalog, reqs = _get_trace(tspec, sz)
        h = grid.full_h if full else grid.h
        kmax_guess = min(max(4 * grid.k, 128), catalog.shape[0])
        for kth in grid.cf_kths:
            c_f = float(calibrate(catalog, kth))
            specs = grid.policy_specs(c_f, h, grid.k, full)
            kmax = max([max(int(s.params.get("k") or grid.k),
                            int(s.params.get("k_prime") or 0))
                        for s in specs] + [grid.k, 16])
            oracle = _get_oracle(tspec, sz, catalog, reqs, max(kmax, kmax_guess), device)
            for spec in specs:
                row = run_cell(grid.name, tspec, spec, catalog, reqs, oracle, c_f, kth, h,
                               grid.batch, device, prepare)
                rows.append(row)
                _emit_row(grid.name, row, f"cf@{kth}/" if len(grid.cf_kths) > 1 else "")
        if grid.summarize:
            for label, value in grid.summarize(
                    [r for r in rows if r["trace"] == tspec.to_dict()]):
                _emit(f"{grid.name}/{tspec.name}/{label}", 0.0, value)
    return rows


def _improvement_vs_2nd(rows):
    acai = max((r["nag"] for r in rows if r["policy"]["policy"] == "acai"),
               default=float("-inf"))
    second = max((r["nag"] for r in rows if r["policy"]["policy"] != "acai"),
                 default=float("-inf"))
    yield ("improvement_vs_2nd", f"{(acai - second) / max(second, 1e-9):+.2%}")


def _acai(h, k, c_f, batch=8, **extra) -> PolicySpec:
    # c_f rides in the spec, so every row's policy dict is self-contained
    return PolicySpec("acai", {"h": h, "k": k, "c_f": c_f, "eta": extra.pop(
        "eta", 0.05 / c_f), "batch": batch, **extra})


def _grid_experiments(c_f, h, k, full=False):
    """The canonical suite: every registered policy (the baselines at the
    paper's defaults: k' = 2k, C_theta = 1.5 c_f) on every scenario."""
    specs = [_acai(h, k, c_f)]
    for name in ("sim_lru", "cls_lru", "rnd_lru"):
        specs.append(PolicySpec(name, {"h": h, "k": k, "k_prime": 2 * k,
                                       "c_theta": 1.5 * c_f}))
    specs += [PolicySpec("lru", {"h": h, "k": k}),
              PolicySpec("qcache", {"h": h, "k": k})]
    return specs


GRIDS: Dict[str, Grid] = {
    "experiments": Grid(
        "experiments", "all registered policies x the four static scenarios",
        traces=tuple(TraceSpec(n) for n in ("sift_like", "amazon_like",
                                            "flash_crowd", "adversarial")),
        policies=_grid_experiments, summarize=_improvement_vs_2nd),
}


def from_bench(bench: dict, device=None, prepare: Callable = None) -> list[dict]:
    """Replay the rows of a reference results file (the dict of
    BENCH_experiments.json): each row's policy dict on its trace at the
    file's n and t, a trace's c_f taken from its acai row (full
    precision), one shared oracle a trace.  Each returned row carries the
    file's NAG as `reference_nag`."""
    device = resolve_device(device)
    sz = {"n": int(bench["n"]), "t": int(bench["t"])}
    by_trace: Dict[str, list] = {}
    for r in bench["rows"]:
        by_trace.setdefault(json.dumps(r["trace"], sort_keys=True), []).append(r)
    out = []
    for key, rows in by_trace.items():
        tspec = TraceSpec.from_dict(json.loads(key))
        cfs = [r["policy"]["c_f"] for r in rows if r["policy"]["policy"] == "acai"]
        if not cfs:
            raise ValueError(f"{tspec.name}: no acai row to take c_f from")
        c_f = float(cfs[0])
        catalog, reqs = _get_trace(tspec, sz)
        specs = [PolicySpec.from_dict(r["policy"]) for r in rows]
        kmax = max([max(int(s.params.get("k", 10)), int(s.params.get("k_prime") or 0))
                    for s in specs] + [128])
        oracle = _get_oracle(tspec, sz, catalog, reqs, min(kmax, catalog.shape[0]), device)
        for r, spec in zip(rows, specs):
            row = run_cell(r.get("grid", "experiments"), tspec, spec, catalog, reqs,
                           oracle, c_f, r.get("cf_kth", 50), r["h"], 8, device, prepare)
            row["reference_nag"] = r["nag"]
            out.append(row)
            _emit_row("from-bench", row,
                      extra=f";file_NAG={r['nag']:.4f};"
                            f"diff={row['nag_full'] - r['nag']:+.5f}")
    return out


def card_line() -> str:
    """The card as `nvidia-smi --query-gpu=name,power.limit` prints it
    (the device name alone where nvidia-smi is missing)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="the paper's sizes")
    ap.add_argument("--from-bench", default=None, metavar="PATH",
                    help="replay the rows of a reference results file")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the rows and the card as JSON")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ops.reset_launches()
    t0 = time.perf_counter()
    if args.from_bench:
        with open(args.from_bench) as f:
            bench = json.load(f)
        rows = from_bench(bench, device)
        sz = {"n": bench["n"], "t": bench["t"]}
        base = [r for r in rows if r["policy"]["policy"] != "acai"]
        acai = [r for r in rows if r["policy"]["policy"] == "acai"]
        for what, rs in (("baselines", base), ("acai", acai)):
            if rs:
                worst = max(rs, key=lambda r: abs(r["nag_full"] - r["reference_nag"]))
                _emit(f"from-bench/max_abs_diff/{what}", 0.0,
                     f"{abs(worst['nag_full'] - worst['reference_nag']):.5f} "
                     f"({worst['trace']['name']}/{worst['label']})")
    else:
        rows = run_grid(GRIDS["experiments"], full=args.full, device=device)
        sz = _sizes(args.full)
    seconds = time.perf_counter() - t0
    card = card_line() if device.type == "cuda" else "cpu"
    _emit("experiments/seconds", 0.0, f"{seconds:.1f} on {card}; launches {dict(ops.LAUNCHES)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"grid": "from-bench" if args.from_bench else "experiments",
                       "source": args.from_bench, "full": args.full, **sz,
                       "device": device.type, "card": card,
                       "torch": torch.__version__, "seconds": seconds,
                       "policies": list(PA.registered_policies()),
                       "traces": sorted({r["trace"]["name"] for r in rows}),
                       "rows": rows}, f, indent=2)
            f.write("\n")
        _emit("experiments/json", 0.0, args.out)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
