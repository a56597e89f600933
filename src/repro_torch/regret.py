"""Theorem IV.1 on the port: AÇAI's (1 - 1/e)-regret grows sub-linearly, so
its time-averaged psi-regret against the best static allocation in
hindsight decays with the horizon T (port of `benchmarks/regret.py`, with
its own copy of the pieces of `benchmarks/common.py` it needs).

    PYTHONPATH=src python -m repro_torch.regret [--full] [--trace sift]
        [--device cpu] [--out PATH]

Per horizon T (500, 1500, 4000; 2000, 8000, 30000 at --full) AÇAI replays
the trace's first T requests one request a step (the sequential replay,
exact candidates: the `pairwise_l2` kernel on the card) at eta* of
Theorem IV.1, and the line `regret/<trace>/T<T>` prints psi * G(static) -
G(AÇAI) per step, psi = 1 - 1/e, with the static allocation the h objects
most often nearest to a request (the server oracle's answers: `l2_topk`).
The sizes are the reference's: n 4000 (20000 at --full), d 32, h 100
(1000), k 10.  `--out` writes the rates, with the card's name and power
limit, under "regret" in PATH (keeping what else PATH holds).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import baselines as B
from repro_torch.core import gain as G
from repro_torch.core import oma, policy, trace
from repro_torch.core.costs import calibrate_fetch_cost
from repro_torch.experiments import _emit, _sizes, card_line

# c_f = the average distance of the i-th neighbour, for these i (Sec. V-C)
CF_KTHS = (2, 10, 50, 100, 500, 1000)
PSI = 1 - 1 / np.e
D, KMAX = 32, 128             # the trace's width; the server oracle's k
C_REMOTE, C_LOCAL = 64, 16    # AÇAI's candidates


@dataclasses.dataclass
class BenchSetup:
    catalog: np.ndarray
    requests: np.ndarray
    cat: torch.Tensor          # the catalog on the run's device
    oracle: B.ServerOracle
    cf_table: dict             # i-th neighbour -> average distance


def get_setup(kind: str, n: int, t: int, device=None, idx=None) -> BenchSetup:
    """The trace (sift|amazon aliases or a registered scenario) at d 32, a
    server oracle at kmax 128 over its requests, and c_f at each of
    CF_KTHS below n by `calibrate_fetch_cost` over 256 sampled rows
    (`idx`, when given, is the sample), on `device`."""
    device = resolve_device(device)
    name = {"sift": "sift_like", "amazon": "amazon_like"}.get(kind, kind)
    catalog, reqs, _ids = trace.build_trace(name, n=n, d=D, t=t)
    cat = torch.from_numpy(catalog).to(device)
    oracle = B.ServerOracle(catalog, reqs, kmax=KMAX, device=device)
    cf = {i: calibrate_fetch_cost(cat, kth=i, sample=256, idx=idx, device=device)
          for i in CF_KTHS if i < n}
    return BenchSetup(catalog, reqs, cat, oracle, cf)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_acai(setup: BenchSetup, *, h, k, c_f, eta, requests, state=None, uniforms=None):
    """AÇAI's sequential replay (one request a step, exact candidates,
    coupled rounding) from `state` (default `policy.init_state`, seed 0)
    with the steps' rounding uniforms `uniforms` (T, N) when given.
    Returns ({"gain": each request's gain (numpy), "state": the final
    state}, seconds a request)."""
    dev = setup.cat.device
    cfg = policy.AcaiConfig(h=h, k=k, c_f=c_f, c_remote=C_REMOTE, c_local=C_LOCAL,
                            oma=oma.OMAConfig(eta=eta))
    replay = policy.make_replay(
        cfg, policy.exact_candidate_fn_batched(setup.cat, C_REMOTE, C_LOCAL))
    if state is None:
        state = policy.init_state(setup.cat.shape[0], cfg, device=dev)
    if uniforms is not None:
        uniforms = torch.as_tensor(uniforms, dtype=torch.float32).to(dev)
    rq = torch.as_tensor(requests, dtype=torch.float32).to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    state, m = replay(state, rq, uniforms)
    _sync(dev)
    dt = (time.perf_counter() - t0) / rq.shape[0]
    return {"gain": m.gain_int.cpu().numpy(), "state": state}, dt


def static_allocation(setup: BenchSetup, h: int) -> np.ndarray:
    """The static comparator: the h objects most often nearest to a
    request (greedy popularity), as a 0/1 vector."""
    n = setup.catalog.shape[0]
    near = setup.oracle.ids[:, 0]
    top = np.bincount(near, minlength=n).argsort()[::-1][:h]
    x_static = np.zeros(n, np.float32)
    x_static[top] = 1.0
    return x_static


def _static_best_gain(s: BenchSetup, x_static, k, c_f, requests, chunk: int = 16) -> float:
    """The mean gain G(r, x_static) over every (T // 400)-th request, each
    request's candidates the whole catalog."""
    dev = s.cat.device
    rs = torch.as_tensor(np.asarray(requests)[::max(len(requests) // 400, 1)],
                         dtype=torch.float32).to(dev)
    x = torch.as_tensor(x_static).to(dev)
    vals = []
    for i in range(0, rs.shape[0], chunk):
        r = rs[i:i + chunk]
        d = torch.sum((s.cat[None, :, :] - r[:, None, :]) ** 2, dim=-1)
        vals.append(G.gain_value_batch(d, x.expand(r.shape[0], -1), k, c_f))
    return float(np.mean(torch.cat(vals).cpu().numpy().astype(np.float64)))


def main(full: bool = False, kind: str = "sift", *, n: int = None, t: int = None,
         h: int = None, k: int = 10, horizons=None, device=None, idx=None,
         inject: Optional[Callable] = None) -> dict:
    """The psi-regret rate a step at each horizon: {T: rate}.  Sizes, h and
    the horizons default to the reference's (by `full`); `inject(T)`, when
    given, returns `run_acai`'s state and uniforms for that horizon (a test
    hands the reference's in); `idx` is c_f's calibration sample."""
    sz = _sizes(full)
    n, t = n or sz["n"], t or sz["t"]
    h = h or (1000 if full else 100)
    horizons = horizons or ((2000, 8000, 30000) if full else (500, 1500, 4000))
    s = get_setup(kind, n, t, device=device, idx=idx)
    c_f = s.cf_table[50]
    x_static = static_allocation(s, h)
    out = {}
    for t_len in horizons:
        reqs = s.requests[:t_len]
        eta = oma.theoretical_eta(float(np.sqrt(s.cf_table[50])), c_f, h, n, t_len)
        m, dt = run_acai(s, h=h, k=k, c_f=c_f, requests=reqs, eta=eta,
                         **(inject(t_len) if inject else {}))
        static_avg = _static_best_gain(s, x_static, k, c_f, reqs)
        avg_gain = float(m["gain"].astype(np.float64).mean())
        out[t_len] = PSI * static_avg - avg_gain  # the psi-regret a step
        _emit(f"regret/{kind}/T{t_len}", dt * 1e6, f"psi_regret_per_step={out[t_len]:.4f}")
    ts = sorted(out)
    _emit(f"regret/{kind}/decay", 0.0,
          f"rate@{ts[0]}={out[ts[0]]:.4f};rate@{ts[-1]}={out[ts[-1]]:.4f}")
    return out


def cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="the paper's sizes")
    ap.add_argument("--trace", default="sift",
                    help="sift|amazon aliases or any registered scenario")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help='write the rates under "regret" in PATH (JSON)')
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    rates = main(args.full, args.trace, device=device)
    seconds = time.perf_counter() - t0
    card = card_line() if device.type == "cuda" else "cpu"
    _emit("regret/seconds", 0.0, f"{seconds:.1f} on {card}")
    if args.out:
        doc = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                doc = json.load(f)
        ts = sorted(rates)
        doc["regret"] = {"full": args.full, "trace": args.trace, **_sizes(args.full),
                         "h": 1000 if args.full else 100, "k": 10, "device": device.type,
                         "card": card, "torch": torch.__version__, "seconds": seconds,
                         "psi_regret_per_step": {str(t_len): r for t_len, r in rates.items()},
                         "decays": all(rates[a] > rates[b] for a, b in zip(ts, ts[1:]))}
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        _emit("regret/json", 0.0, args.out)
    return rates


if __name__ == "__main__":
    cli(sys.argv[1:])
