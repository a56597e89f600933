"""Where the time of the batched serving step goes, on the CUDA card.

    PYTHONPATH=src python -m repro_torch.profile_step [--steps 8] [--n 1000000]

Builds the slice's 1M x 128 configuration (the one chip_smoke.py serves),
then for each of flat and IVF at B = 8 and 64 runs a few warm steps and
profiles `--steps` more with torch.profiler.  Prints, per run, the wall
time per step, the device busy time per step (the union of kernel
intervals on the card's timeline), the idle share (1 - busy / wall) and
the device time by kernel name.  Needs a CUDA card; it does not fall back.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch


def _busy_us(events) -> float:
    """Union length of the device kernel intervals (µs)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import oma, policy, trace
    from repro_torch.core.costs import calibrate_fetch_cost
    from repro_torch.index.base import IndexSpec

    dev = torch.device("cuda", torch.cuda.current_device())
    cat, reqs, _ = trace.sift_like(n=args.n, d=128, t=2048, seed=0)
    c_f = calibrate_fetch_cost(cat, kth=50, device=dev)
    cfg = policy.AcaiConfig(h=400, k=10, c_f=c_f, c_remote=64, c_local=16,
                            oma=oma.OMAConfig(eta=0.05 / c_f))
    state0 = policy.init_state(args.n, cfg, seed=0, device=dev)
    rq = torch.from_numpy(reqs).to(dev)
    for spec in (IndexSpec("flat"),
                 IndexSpec("ivf", {"nlist": 256, "nprobe": 16, "train_iters": 4})):
        for b in (8, 64):
            cache = policy.AcaiCache(cat, dataclasses.replace(cfg, index=spec),
                                     device=dev, state=policy.copy_state(state0))
            warm = 4
            for i in range(warm):
                cache.serve_update_batch(rq[i * b:(i + 1) * b])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(warm, warm + args.steps):
                    cache.serve_update_batch(rq[i * b:(i + 1) * b])
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            busy = _busy_us(prof.events())
            print(f"== {spec.backend} B={b}: wall_us/step={wall_us / args.steps} "
                  f"device_busy_us/step={busy / args.steps} "
                  f"idle_share={1 - busy / wall_us}", flush=True)
            rows = [(e.key, e.device_time_total / args.steps, e.count // args.steps)
                    for e in prof.key_averages() if e.device_time_total > 0]
            for key, us, count in sorted(rows, key=lambda r: -r[1])[:14]:
                print(f"   {us:10.1f} us/step  x{count:<3d} {key[:90]}")
    print(f"card: {torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    main()
