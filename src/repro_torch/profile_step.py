"""Where the time of the batched serving step goes, on the CUDA card.

    PYTHONPATH=src python -m repro_torch.profile_step [--steps 8] [--n 1000000]
        [--index exact flat ivf ivfpq] [--batch 8 64] [--mesh]
    PYTHONPATH=src python -m repro_torch.profile_step --lm [--steps 8]
    PYTHONPATH=other/src python src/repro_torch/profile_step.py [...]

Builds the slice's 1M x 128 configuration (the one chip_smoke.py serves),
then for each of flat, IVF and IVF-PQ at B = 8 and 64 runs a few warm
steps and profiles `--steps` more with torch.profiler (`--index` and
`--batch` pick a subset, `exact` adds the exact candidates; run as a file
with another checkout's `src` on PYTHONPATH, it profiles that checkout's
code).  `--mesh` profiles the sharded step too, on a one-rank NCCL mesh
(repro_torch.core.distributed; exact, and IVF as `ivf_sharded` over the
same lists), beside the single-device step.  With `--lm` it
profiles the LM tier instead, qwen1.5-0.5b at full width as chip_smoke.py
serves it: a 4096-token prefill into an 8192-token cache (the flash
path), and decode steps of a batch of 4 over that cache.  Prints, per
run, the wall time per step, the device busy time per step (the union of
kernel intervals on the card's timeline), the idle share (1 - busy /
wall), the device operations a step (kernels, copies and fills: each one a
launch the host paid for), the device time by kernel name and the host
operations taking the most host time of their own.  For each serving arm
it then runs `--steps` more steps with no profiler and prints the cache's
own host time by phase (`repro_torch.spans`: the median ms of each span,
of the waits and of the step's time outside its phases) and its waits on
the card a step (the batches lie on the card already, so no `upload`).
In the profile the spans are host ranges named `acai.<phase>`.  Needs a
CUDA card; it does not fall back.
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


def _profile(label: str, fn, steps: int) -> None:
    """Profile `steps` calls of fn() and print the step's breakdown."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            fn(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = _busy_us(prof.events())
    ops = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"== {label}: wall_us/step={wall_us / steps} "
          f"device_busy_us/step={busy / steps} "
          f"idle_share={1 - busy / wall_us} device_ops/step={ops / steps}", flush=True)
    rows = [(e.key, e.device_time_total / steps, e.count // steps)
            for e in prof.key_averages() if e.device_time_total > 0]
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:20]:
        print(f"   {us:10.1f} us/step  x{count:<3d} {key[:90]}")
    host = [(e.key, e.self_cpu_time_total / steps, e.count // steps)
            for e in prof.key_averages() if e.self_cpu_time_total > 0]
    for key, us, count in sorted(host, key=lambda r: -r[1])[:12]:
        print(f"   host {us:10.1f} us/step  x{count:<3d} {key[:85]}")


def _print_phases(cache, fn, first: int, steps: int) -> None:
    """Run fn(first), ..., fn(first + steps - 1) with no profiler and print
    the median host ms of each of the cache's spans and its waits a step
    over its unprofiled steps, the first one (a warm-up) left out."""
    from repro_torch import spans

    for i in range(steps):
        fn(first + i)
    torch.cuda.synchronize()
    snap = cache.spans.snapshot()
    rows = ~snap["profiled"]
    rows[0] = False
    med = spans.medians_ms(snap, rows)
    print(f"   spans, median host ms a step over {int(rows.sum())} unprofiled steps: "
          + " ".join(f"{k}={v:.4f}" for k, v in med.items() if k != "waits")
          + f"; waits a step {med['waits']:g}", flush=True)


def profile_lm(steps: int, dev: torch.device) -> None:
    """qwen1.5-0.5b, random weights: prefill and decode breakdowns."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_cache, init_params

    cfg = get_config("qwen1.5-0.5b")
    params = init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (1, 4096), generator=gen, device=dev)
    cache = init_cache(cfg, 1, 8192, device=dev)

    def prefill(_i):
        forward(params, cfg, tokens=prompt, cache=cache, cache_len=0)

    prefill(0)
    _profile("lm prefill S=4096 T=8192", prefill, 2)
    cache = init_cache(cfg, 4, 8192, device=dev)
    last = torch.randint(0, cfg.vocab, (4, 1), generator=gen, device=dev)

    def decode(i):
        forward(params, cfg, tokens=last, cache=cache, cache_len=4096 + i)

    for i in range(2):
        decode(i)
    _profile("lm decode B=4 T=8192", lambda i: decode(2 + i), steps)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--lm", action="store_true")
    ap.add_argument("--index", nargs="+", default=["flat", "ivf", "ivfpq"],
                    choices=["exact", "flat", "ivf", "ivfpq"])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 64])
    ap.add_argument("--mesh", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    if args.lm:
        profile_lm(args.steps, dev)
        print(f"card: {torch.cuda.get_device_name(0)}")
        return

    from repro_torch.core import oma, policy, trace
    from repro_torch.core.costs import calibrate_fetch_cost
    from repro_torch.index.base import IndexSpec

    cat, reqs, _ = trace.sift_like(n=args.n, d=128, t=2048, seed=0)
    c_f = calibrate_fetch_cost(cat, kth=50, device=dev)
    cfg = policy.AcaiConfig(h=400, k=10, c_f=c_f, c_remote=64, c_local=16,
                            oma=oma.OMAConfig(eta=0.05 / c_f))
    state0 = policy.init_state(args.n, cfg, seed=0, device=dev)
    rq = torch.from_numpy(reqs).to(dev)
    specs = {"exact": None, "flat": IndexSpec("flat"),
             "ivf": IndexSpec("ivf", {"nlist": 256, "nprobe": 16, "train_iters": 4}),
             "ivfpq": IndexSpec("ivfpq", {"nlist": 256, "nprobe": 16, "m": 8, "refine": 4})}
    mesh = store = None
    if args.mesh:
        import tempfile

        import torch.distributed as dist
        from repro_torch.core.distributed import build_sharded_ivf
        from repro_torch.launch.mesh import make_host_mesh

        store = tempfile.mkdtemp(prefix="profile_step_store_")
        dist.init_process_group("nccl", init_method=f"file://{store}/s", rank=0,
                                world_size=1)
        mesh = make_host_mesh("cuda")
        cfg = dataclasses.replace(cfg, oma=dataclasses.replace(
            cfg.oma, projection_topk=2 * cfg.h + 64))  # the sharded step's top_a
        if "ivf" in args.index:  # one trained structure for both arms
            ivf = build_sharded_ivf(cat, 1, nlist=256, nprobe=16, train_iters=4, device=dev)
            lists = {"nlist": 256, "nprobe": 16, "centroids": ivf.centroids.cpu().numpy(),
                     "invlists": ivf.invlists.cpu().numpy()}
            specs["ivf"] = IndexSpec("ivf", lists)
            specs["ivf_sharded"] = IndexSpec("ivf_sharded", lists)
    arms = []
    for name in args.index:
        arms.append((name, specs[name], None))
        if mesh is not None and name in ("exact", "ivf"):
            arms.append((f"{name} sharded", specs["ivf_sharded" if name == "ivf" else name],
                         mesh))
    for name, spec, m in arms:
        for b in args.batch:
            kw = {"device": dev} if m is None else {"mesh": m}
            cache = policy.AcaiCache(cat, dataclasses.replace(cfg, index=spec),
                                     state=policy.copy_state(state0), **kw)
            warm, nb = 4, rq.shape[0] // b

            def step(i):
                j = i % nb
                cache.serve_update_batch(rq[j * b:(j + 1) * b])

            for i in range(warm):
                step(i)
            _profile(f"{name} B={b}", lambda i: step(warm + i), args.steps)
            _print_phases(cache, step, warm + args.steps, args.steps)
    if store is not None:
        import shutil

        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    print(f"card: {torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    main()
