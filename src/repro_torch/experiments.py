"""Config-driven experiment harness: (TraceSpec x PolicySpec) grids (port
of `benchmarks/experiments.py`: the canonical cross-policy grid and the
paper's eight figure grids).

A grid names its traces, its policies and its sizes; `run_grid` generates
each trace once, precomputes ONE `ServerOracle` per trace (shared by every
baseline cell; its exact kNN scan is the `l2_topk` kernel on the card),
calibrates c_f, builds each policy through `build_policy`, replays it and
returns NAG / hit ratio / p50 step latency per (trace x policy) cell, then
prints the grid's figure-level summary lines.

The registered grids (`GRIDS`, `--list`): `experiments` (every policy on
the four static scenarios), fig1 (NAG vs requests against every tuned
baseline), fig2 (vs cache size h), fig3 (vs c_f, six calibrations), fig4
(vs answers per request k), fig5 (robustness: AÇAI's eta sweep against
the baselines' (k', C_theta) grids), fig6 (negentropy vs euclidean mirror
maps), fig7 (dissection: indexes vs OMA, with augmented baselines) and
fig8 (rounding schemes).

    PYTHONPATH=src python -m repro_torch.experiments [--grid NAME|all]
        [--trace SCENARIO] [--full] [--device cpu] [--out PATH]
    PYTHONPATH=src python -m repro_torch.experiments --list
    PYTHONPATH=src python -m repro_torch.experiments \\
        --from-bench BENCH_experiments.json [--device cpu] [--out PATH]

`--grid all` runs fig1-fig8.  `--trace` keeps one scenario (the aliases
sift / amazon accepted); a scenario outside a grid's traces runs on its
default `TraceSpec`.  `--from-bench` replays each row of a reference
results file with the row's own policy dict (`PolicySpec.from_dict`) on
the row's trace at the file's n and t; a trace's c_f is the
full-precision c_f of its acai row.  It prints each row's NAG beside the
file's.  `--out` writes the rows, the summary lines and the card's name
and power limit as JSON (a trace filter is recorded in it).
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

# trace-name aliases of the reference's command line (--trace sift|amazon)
TRACE_ALIASES = {"sift": "sift_like", "amazon": "amazon_like"}


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


def _tuned_baselines(c_f, h, k, names=("sim_lru", "cls_lru", "rnd_lru"),
                     extra=("lru", "qcache"), augmented=False):
    """The paper's baseline tuning protocol as grid cells: (k', C_theta)
    sweeps for the SIM-LRU family, one cell for each parameter-free
    policy; `augmented` gives each the AÇAI serving rule (fig7)."""
    base = {"h": h, "k": k}
    if augmented:
        base["augmented"] = True
    specs = []
    for n in names:
        specs += sweep(n, base, k_prime=sorted({k, 2 * k, min(4 * k, h)}),
                       c_theta=[1.0 * c_f, 1.5 * c_f, 2.0 * c_f])
    for n in extra:
        specs.append(PolicySpec(n, dict(base)))
    return specs


def _fig2_hs(full):
    return (50, 100, 200, 500, 1000, 2000) if full else (50, 100, 200, 400)


def _fig4_ks(full):
    return (10, 20, 30, 50, 100) if full else (5, 10, 20, 40)


def _fig5_hs(full):
    return (50, 1000) if full else (50, 200)


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


def run_grid(grid: Grid, full: bool = False, trace_filter: str = None, sizes: dict = None,
             device=None, calibrate: Callable = None, prepare: Callable = None) -> list[dict]:
    """Run every (trace x policy) cell of a grid; returns the row dicts.

    Per trace (only `trace_filter`'s, when given): one generation, one
    ServerOracle precompute on `device` (kmax the largest k' any cell asks
    for, at least 128), one c_f per `grid.cf_kths` entry
    (`calibrate(catalog, kth)`, default `calibrate_fetch_cost(kth,
    sample=256)` on `device`), then the grid's summary lines.  `prepare`
    goes to `run_cell`."""
    device = resolve_device(device)
    sz = sizes or _sizes(full)
    calibrate = calibrate or (lambda cat, kth: _calibrate(cat, kth, device))
    rows = []
    for tspec in grid.traces:
        if trace_filter and tspec.name != trace_filter:
            continue
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
        for name, value in summary_lines(grid, [r for r in rows
                                                if r["trace"] == tspec.to_dict()]):
            _emit(name, 0.0, value)
    return rows


def summary_lines(grid: Grid, rows: list) -> list:
    """The grid's summary lines over its rows, trace by trace in row
    order: [(f"{grid}/{trace}/{label}", value)]."""
    if not grid.summarize:
        return []
    by: Dict[str, list] = {}
    for r in rows:
        by.setdefault(json.dumps(r["trace"], sort_keys=True), []).append(r)
    return [(f"{grid.name}/{rs[0]['trace']['name']}/{label}", value)
            for rs in by.values() for label, value in grid.summarize(rs)]


# ---------------------------------------------------------------------------
# Figure-level summaries
# ---------------------------------------------------------------------------

def _best(rows, name):
    vals = [r["nag"] for r in rows if r["policy"]["policy"] == name]
    return max(vals) if vals else float("-inf")


def _improvement_vs_2nd(rows):
    acai = _best(rows, "acai")
    second = max((r["nag"] for r in rows if r["policy"]["policy"] != "acai"),
                 default=float("-inf"))
    yield ("improvement_vs_2nd", f"{(acai - second) / max(second, 1e-9):+.2%}")


def _improvement_per(key: str):
    """Per-sweep-point improvement: the trace's rows grouped by the swept
    field (h for fig2, cf_kth for fig3, k for fig4), AÇAI against the
    tuned 2nd best within each point; cells computed under different cost
    models or capacities are never pooled."""

    def summarize(rows):
        by = {}
        for r in rows:
            by.setdefault(r[key], []).append(r)
        for val, rs in sorted(by.items()):
            for label, v in _improvement_vs_2nd(rs):
                yield (f"{key}{val}/{label}", v)

    return summarize


def _spread_by_policy(rows):
    """Per (h, policy): the NAG spread over that policy's hyper-parameter
    grid at a fixed capacity (fig5: AÇAI flat over two orders of magnitude
    of eta, the baselines swinging with (k', C_theta))."""
    by = {}
    for r in rows:
        by.setdefault((r["h"], r["policy"]["policy"]), []).append(r["nag"])
    for (h, name), vals in sorted(by.items()):
        spread = (max(vals) - min(vals)) / max(max(vals), 1e-9)
        yield (f"h{h}/{name}-spread", f"{spread:.3f}")


def _summarize_fig6(rows):
    """Per mirror map: the best NAG over the eta grid and that cell's t90
    (the paper's 'same gain in a shorter time')."""
    by = {}
    for r in rows:
        by.setdefault(r["policy"].get("mirror", "negentropy"), []).append(r)
    for mirror, rs in sorted(by.items()):
        best = max(rs, key=lambda r: r["nag"])
        yield (f"{mirror}/best", f"{best['nag']:.4f}")
        yield (f"{mirror}/t90", str(best["t90"]))


def _summarize_fig7(rows):
    """The paper's protocol (Sec. V-C): only the augmented twin of the best
    plain baseline's policy counts (the first of equal NAGs in row order),
    so the index-vs-OMA split never mixes update rules."""
    acai = _best(rows, "acai")
    plain = [r for r in rows if r["policy"]["policy"] != "acai"
             and not r["policy"].get("augmented")]
    best_plain_row = max(plain, key=lambda r: r["nag"], default=None)
    best_plain = best_plain_row["nag"] if best_plain_row else 0.0
    second_name = best_plain_row["policy"]["policy"] if best_plain_row else ""
    aug = [r for r in rows if r["policy"].get("augmented")
           and r["policy"]["policy"] == second_name]
    best_aug = max((r["nag"] for r in aug), default=0.0)
    total = acai - best_plain
    from_idx = max(min(best_aug - best_plain, total), 0.0)
    share = from_idx / max(total, 1e-9)
    yield ("2nd_best", f"{second_name}:{best_plain:.4f}")
    yield ("2nd+index", f"{best_aug:.4f}")
    yield ("share_from_indexes", f"{share:.2f}")
    yield ("share_from_oma", f"{1 - share:.2f}")


def _summarize_fig8(rows):
    """Per rounding scheme: update traffic and occupancy concentration
    under the relaxed capacity constraint (App. G)."""
    for r in rows:
        label = (f"{r['policy']['rounding']}-M{r['policy']['round_every']}"
                 if r["policy"]["rounding"] == "depround" else r["policy"]["rounding"])
        yield (f"{label}/fetches_per_req", f"{r['fetches_per_req']:.3f}")
        yield (f"{label}/occupancy",
               f"mean={r['occupancy_mean']:.1f};p99dev={r['occupancy_p99_dev']:.3f}")


# ---------------------------------------------------------------------------
# Named grids: the canonical cross-policy suite and the eight figures
# ---------------------------------------------------------------------------


def _acai(h, k, c_f, batch=8, **extra) -> PolicySpec:
    # c_f rides in the spec, so every row's policy dict is self-contained
    return PolicySpec("acai", {"h": h, "k": k, "c_f": c_f, "eta": extra.pop(
        "eta", 0.05 / c_f), "batch": batch, **extra})


_SIFT = TraceSpec("sift_like")
_AMZN = TraceSpec("amazon_like")
_FLASH = TraceSpec("flash_crowd")
_ADV = TraceSpec("adversarial")


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


def _grid_fig1(c_f, h, k, full=False):
    return [_acai(h, k, c_f)] + _tuned_baselines(c_f, h, k)


def _grid_fig2(c_f, h, k, full=False):
    return [s for hh in _fig2_hs(full)
            for s in ([_acai(hh, k, c_f)]
                      + _tuned_baselines(c_f, hh, k, names=("sim_lru", "cls_lru"),
                                         extra=("qcache",)))]


def _grid_fig3(c_f, h, k, full=False):
    # c_f is swept by the grid's cf_kths: the baselines' C_theta tracks
    # each c_f through the tuned sweep, AÇAI's eta through 0.05 / c_f
    return [_acai(h, k, c_f)] + _tuned_baselines(c_f, h, k, names=("sim_lru", "cls_lru"),
                                                 extra=())


def _grid_fig4(c_f, h, k, full=False):
    return [s for kk in _fig4_ks(full)
            for s in ([_acai(h, kk, c_f, c_remote=max(64, 4 * kk), c_local=max(16, kk))]
                      + _tuned_baselines(c_f, h, kk, names=("sim_lru", "cls_lru"),
                                         extra=()))]


def _grid_fig5(c_f, h, k, full=False):
    return [s for hh in _fig5_hs(full)
            for s in ([_acai(hh, k, c_f, eta=0.05 / c_f * m)
                       for m in (0.1, 0.3, 1.0, 3.0, 10.0)]
                      + _tuned_baselines(c_f, hh, k, names=("sim_lru", "cls_lru"),
                                         extra=()))]


def _grid_fig6(c_f, h, k, full=False):
    return ([_acai(h, k, c_f, eta=e, mirror="negentropy")
             for e in (0.01 / c_f, 0.05 / c_f, 0.2 / c_f)]
            + [_acai(h, k, c_f, eta=e, mirror="euclidean")
               for e in (0.1 / (c_f * h), 0.5 / (c_f * h), 2.0 / (c_f * h))])


def _grid_fig7(c_f, h, k, full=False):
    # dissection: the plain tuned baselines, their augmented twins (AÇAI's
    # serving rule over the baseline's update logic) and AÇAI
    return ([_acai(h, k, c_f)]
            + _tuned_baselines(c_f, h, k, names=("sim_lru", "cls_lru"), extra=("qcache",))
            + _tuned_baselines(c_f, h, k, names=("sim_lru", "cls_lru"), extra=("qcache",),
                               augmented=True))


def _grid_fig8(c_f, h, k, full=False):
    return [_acai(h, k, c_f, rounding=r, round_every=m)
            for r, m in (("coupled", 1), ("independent", 1), ("depround", 1),
                         ("depround", 20), ("depround", 100))]


GRIDS: Dict[str, Grid] = {g.name: g for g in (
    Grid("experiments", "all registered policies × all registered scenarios (BENCH json)",
         traces=(_SIFT, _AMZN, _FLASH, _ADV), policies=_grid_experiments,
         summarize=_improvement_vs_2nd),
    Grid("fig1", "NAG vs requests: AÇAI vs every tuned baseline", traces=(_SIFT, _AMZN),
         policies=_grid_fig1, summarize=_improvement_vs_2nd),
    Grid("fig2", "NAG vs cache size h", traces=(_SIFT,), policies=_grid_fig2,
         summarize=_improvement_per("h")),
    Grid("fig3", "NAG vs retrieval cost c_f (c_f = avg dist to i-th neighbour)",
         traces=(_SIFT,), cf_kths=(2, 10, 50, 100, 500, 1000), policies=_grid_fig3,
         summarize=_improvement_per("cf_kth")),
    Grid("fig4", "NAG vs answers-per-request k", traces=(_SIFT,), policies=_grid_fig4,
         summarize=_improvement_per("k")),
    Grid("fig5", "robustness: AÇAI eta sweep vs baseline (k', C_theta) grids",
         traces=(_SIFT,), policies=_grid_fig5, summarize=_spread_by_policy),
    Grid("fig6", "negentropy vs euclidean mirror maps", traces=(_SIFT,), h=100, full_h=100,
         policies=_grid_fig6, summarize=_summarize_fig6),
    Grid("fig7", "dissection: how much of AÇAI's edge is indexes vs OMA",
         traces=(_SIFT, _AMZN), policies=_grid_fig7, summarize=_summarize_fig7),
    Grid("fig8", "rounding schemes: update cost vs reactivity", traces=(_AMZN,),
         policies=_grid_fig8, summarize=_summarize_fig8),
)}
FIGURES = tuple(name for name in GRIDS if name.startswith("fig"))


def list_grids() -> str:
    lines = ["registered grids:"]
    for name, g in GRIDS.items():
        lines.append(f"  {name:12s} {g.desc}")
    lines.append("registered policies: " + ", ".join(PA.registered_policies()))
    lines.append("registered traces:   " + ", ".join(T.registered_traces()))
    return "\n".join(lines)


def named_grid(name: str, trace: str = None) -> Tuple[Grid, Optional[str]]:
    """The grid `name` and its trace filter for `trace` (the aliases
    sift / amazon accepted).  A registered scenario outside the grid's
    traces replaces them with its default-parameter `TraceSpec`; an
    unregistered one raises."""
    grid = GRIDS[name]
    tf = TRACE_ALIASES.get(trace, trace) if trace else None
    if tf and all(t.name != tf for t in grid.traces):
        if tf not in T.registered_traces():
            raise ValueError(T._unknown_trace_msg(tf))
        grid = dataclasses.replace(grid, traces=(TraceSpec(tf),))
    return grid, tf


def run_named(name: str, full: bool = False, trace: str = None, **kw) -> list[dict]:
    """Run one named grid, filtered to one scenario when `trace` is given
    (`named_grid`); `kw` goes to `run_grid` (sizes, device, calibrate,
    prepare)."""
    grid, tf = named_grid(name, trace)
    return run_grid(grid, full=full, trace_filter=tf, **kw)


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
    ap.add_argument("--grid", default="experiments", choices=sorted(GRIDS) + ["all"],
                    help="a registered grid, or all = fig1-fig8")
    ap.add_argument("--trace", default=None,
                    help="one scenario (sift|amazon aliases or any registered one)")
    ap.add_argument("--list", action="store_true", help="list the grids and exit")
    ap.add_argument("--full", action="store_true", help="the paper's sizes")
    ap.add_argument("--from-bench", default=None, metavar="PATH",
                    help="replay the rows of a reference results file")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the rows, the summary lines and the card as JSON")
    args = ap.parse_args(argv)
    if args.list:
        print(list_grids())
        return []
    device = resolve_device(args.device)
    ops.reset_launches()
    t0 = time.perf_counter()
    summary, seconds_by_grid, tf = [], {}, None
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
        rows = []
        for name in (FIGURES if args.grid == "all" else (args.grid,)):
            grid, tf = named_grid(name, args.trace)
            t1 = time.perf_counter()
            grid_rows = run_grid(grid, full=args.full, trace_filter=tf, device=device)
            seconds_by_grid[name] = time.perf_counter() - t1
            summary += summary_lines(grid, grid_rows)
            rows += grid_rows
        sz = _sizes(args.full)
    seconds = time.perf_counter() - t0
    card = card_line() if device.type == "cuda" else "cpu"
    _emit("experiments/seconds", 0.0, f"{seconds:.1f} on {card}; launches {dict(ops.LAUNCHES)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"grid": "from-bench" if args.from_bench else args.grid,
                       "source": args.from_bench, "trace_filter": tf, "full": args.full,
                       **sz, "device": device.type, "card": card,
                       "torch": torch.__version__, "seconds": seconds,
                       "seconds_by_grid": seconds_by_grid,
                       "policies": list(PA.registered_policies()),
                       "traces": sorted({r["trace"]["name"] for r in rows}),
                       "summary": dict(summary), "rows": rows}, f, indent=2)
            f.write("\n")
        _emit("experiments/json", 0.0, args.out + (f" (trace filter {tf})" if tf else ""))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
