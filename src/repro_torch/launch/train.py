"""Training launcher of the port (port of `repro.launch.train`): any --arch
end to end (SMOKE sizes on the CPU, full width on the card), with
checkpoint / restart fault tolerance and straggler monitoring.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --smoke --steps 100 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --seq-len 8192 --batch 1 --steps 6

Weights come from seed 0 and the data is `SyntheticDataset`'s Zipf stream.
Flags beyond the reference's:

  --device cpu   run on the CPU (the card is the default)
  --profile      trace the last step with torch.profiler and report its
                 device time, and the share of it spent in the attention
                 backward (`ops.FLASH_BACKWARD_RANGE`)

`main(argv)` returns the run's figures: losses, grad norms, step times
(host clock, each step ending in a synchronize), peak device memory,
kernel launches a step (by kernel and by `ops.SHAPE_LAUNCHES` key), and
the last step's largest |gradient| of every attention projection.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from collections import Counter

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, SMOKE_ARCHS
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.kernels import ops
from repro_torch.train import OptConfig, init_train_state, make_train_step
from repro_torch.train.data import Prefetcher, SyntheticDataset, to_device
from repro_torch.train.fault import StragglerMonitor, TrainLoop

# the attention projections whose gradients a run reports (GQA; MLA's)
ATTN_WEIGHTS = ("wq", "wk", "wv", "bq", "bk", "bv", "wq_a", "wq_b", "wkv_a", "wk_b", "wv_b")


def attention_grads(grads: dict) -> dict:
    """{parameter name: max |g|} of every attention projection (NaN where
    a gradient is not finite)."""
    out = {}
    for name, g in grads.items():
        parts = name.split(".")
        if len(parts) >= 2 and parts[-2] == "mixer" and parts[-1] in ATTN_WEIGHTS:
            g = g.detach().float()
            out[name] = float(g.abs().max()) if bool(torch.isfinite(g).all()) else float("nan")
    return out


def profile_summary(prof, on_cuda: bool) -> dict:
    """A traced step's kernel time, in ms, and the part of it inside the
    attention backward's range (`ops.FLASH_BACKWARD_RANGE`): the kernels
    that start within the range's spans on the device.  The trace's
    device events hold the kernels and, for each range, one annotation
    event spanning its kernels; the annotations are not kernel time."""
    if not on_cuda:
        return {"device_ms": None, "attn_backward_device_ms": None, "attn_backward_share": None}
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in device
             if e.name == ops.FLASH_BACKWARD_RANGE]
    kernels = [e for e in device if e.name != ops.FLASH_BACKWARD_RANGE
               and not getattr(e, "is_user_annotation", False)]
    total = sum(e.time_range.end - e.time_range.start for e in kernels)
    attn = sum(e.time_range.end - e.time_range.start for e in kernels
               if any(a <= e.time_range.start < b for a, b in spans))
    return {"device_ms": total / 1e3, "attn_backward_device_ms": attn / 1e3,
            "attn_backward_spans": len(spans),
            "attn_backward_share": attn / total if total and spans else None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--profile", action="store_true",
                    help="trace the last step with torch.profiler")
    args = ap.parse_args(argv)
    if args.batch % args.accum:
        ap.error(f"--batch {args.batch} is not a multiple of --accum {args.accum}")

    device = resolve_device(args.device)
    on_cuda = device.type == "cuda"
    cfg = (SMOKE_ARCHS if args.smoke else ARCHS)[args.arch]
    shape = ShapeSpec("train", args.seq_len, args.batch, "train")
    print(f"arch={cfg.name} params={cfg.param_count():,} "
          f"(active {cfg.active_param_count():,}) opt={cfg.optimizer} device={device}")

    model, opt_state = init_train_state(cfg, seed=0, device=device)
    step_fn = make_train_step(cfg, OptConfig(name=cfg.optimizer, lr=args.lr),
                              accum=args.accum)
    dataset = SyntheticDataset(cfg, shape)
    monitor = StragglerMonitor()
    fig = {"arch": cfg.name, "params": cfg.param_count(), "optimizer": cfg.optimizer,
           "device": str(device), "seq_len": args.seq_len, "batch": args.batch,
           "accum": args.accum, "losses": [], "grad_norms": [], "step_ms": [],
           "launches": [], "shape_launches": [], "profile": None}
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()

    def run_step(batch, step, last):
        nonlocal opt_state
        before, before_shapes = dict(ops.LAUNCHES), Counter(ops.SHAPE_LAUNCHES)
        traced = last and args.profile
        acts = [torch.profiler.ProfilerActivity.CPU] + (
            [torch.profiler.ProfilerActivity.CUDA] if on_cuda else [])
        with (torch.profiler.profile(activities=acts) if traced
              else contextlib.nullcontext()) as prof:
            if on_cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, opt_state, metrics = step_fn(model, opt_state, batch, step)
            loss = float(metrics.loss)  # waits for the step
            if on_cuda:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        if traced:
            fig["profile"] = {"step_ms": dt * 1e3, **profile_summary(prof, on_cuda)}
        monitor.record(step, dt)
        fig["losses"].append(loss)
        fig["grad_norms"].append(float(metrics.grad_norm))
        fig["step_ms"].append(dt * 1e3)
        fig["launches"].append({k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES})
        fig["shape_launches"].append(Counter(ops.SHAPE_LAUNCHES) - before_shapes)
        if step % args.log_every == 0:
            print(f"step {step}: loss={loss:.4f} gnorm={float(metrics.grad_norm):.3f} "
                  f"({dt * 1e3:.1f} ms)")

    if args.ckpt_dir:
        def loop_step(state, batch, step):
            # after a resume the restored parameters are new tensors
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if state["params"][name] is not p:
                        p.copy_(state["params"][name])
            nonlocal opt_state
            opt_state = state["opt"]
            run_step(to_device(batch, cfg, device), step, step == args.steps - 1)
            return {"params": dict(model.named_parameters()), "opt": opt_state}

        loop = TrainLoop(loop_step, {"params": dict(model.named_parameters()),
                                     "opt": opt_state},
                         args.ckpt_dir, ckpt_every=args.ckpt_every, monitor=monitor)
        loop.run(args.steps, dataset.batch)
        fig["restarts"] = loop.restarts
        print(f"done; restarts={loop.restarts} stragglers={len(monitor.flagged)}")
    else:
        prefetcher = Prefetcher(dataset, prefetch=2,
                                put_fn=lambda b: to_device(b, cfg, device))
        try:
            for i in range(args.steps):
                step, batch = prefetcher.next()
                run_step(batch, step, i == args.steps - 1)
        finally:
            prefetcher.stop()
    fig["stragglers"] = len(monitor.flagged)
    fig["attn_grads"] = attention_grads(step_fn.grads) if step_fn.grads else {}
    fig["peak_bytes"] = torch.cuda.max_memory_allocated() if on_cuda else None
    later = fig["step_ms"][1:] or fig["step_ms"]
    fig["median_step_ms"] = float(np.median(later)) if later else None
    if fig["losses"]:
        print(f"final loss {fig['losses'][-1]:.4f} (first {fig['losses'][0]:.4f}); "
              f"median step {fig['median_step_ms']:.1f} ms (steps 2 on)")
    return fig


if __name__ == "__main__":
    main()
