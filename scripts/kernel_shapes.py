#!/usr/bin/env python3
"""Device time and call time of `pairwise_l2` and `ivf_scan` at each shape
the port's main path gives them, on one CUDA card.

    python3 scripts/kernel_shapes.py [--src path/to/checkout/src] [--skip-wide]
    python3 scripts/kernel_shapes.py --designs

For each shape it prints one line with
  - device_ms: the kernel's own time on the card, from torch.profiler's
    kernel events whose name holds the kernel's, summed over the calls;
  - call_ms: CUDA events around back-to-back calls of the wrapper, what a
    caller waits for (the wrapper's other device ops, such as the merge
    sort of a top-k's partials, and host pacing included), taken for
    every shape before the first profiled one;
  - launches: kernel launches of one call;
  - bound_ms / bound_by: bytes over HBM's 3.35 TB/s or float32 operations
    over the FMA units' 67 TFLOP/s, whichever is larger (the data-dependent
    counts, distinct rows and valid slots, come from this run's data);
  - plain_ms: the plain version (kernels/ref.py) by CUDA events;
  - library_ms: one PyTorch call that computes the same function.

The shapes (Q x N x D for pairwise_l2): the cached-row scan (B x 864 x
128), the IVF coarse quantizer (B x 256 x 128), the PQ tables (B x 256 x
16, 8 subspaces), topk_l2's sample bound (B x 16384 x 128 and 64 x 16384
x 1024), the semantic tier's exact scan (1 and 8 x 1M x 1024), k-means'
assignment (1M x 256 x 128, build time); for ivf_scan the IVF probe (B x
16 lists of the 1M x 128 catalog, k 64) and the IVF-PQ exact re-rank of
the index's ADC shortlist (B x 256, k 64; a random 256 of the probed ids
where the tree's IVFPQIndex has no `shortlist`), at B 8 and 64.  `--src`
imports another checkout's
`repro_torch` (its kernels are built from its own sources), so two trees
can be timed in one call; features a tree lacks (the batched PQ tables,
the list-major probe) are taken the way that tree's index takes them.
chip_smoke.py reuses `cases` and `time_cases`.

`--designs` times instead, with the same columns and the device time of
all the call's kernels beside its own (the merge's sort included), the
designs the wrappers choose between by shape: `pairwise_l2`'s 64 x 64 and
32 x 32 tiles at the shapes that take the 64 x 64 tile, and the IVF probe
at B 1 to 64 by the per-query kernel, by the list-major one as planned,
and by the list-major one at 1 to 5 runs a list.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
N_FULL, D_FULL, T_FULL = 1_000_000, 128, 2048
IVF = {"nlist": 256, "nprobe": 16, "train_iters": 4}
IVFPQ = {"nlist": 256, "nprobe": 16, "m": 8, "refine": 4}  # chip_smoke.py's IVFPQ_FULL
CAP, K_REMOTE, REFINE = 2 * 400 + 64, 64, 4
SEM_N, SEM_D, SAMPLE = 1_000_000, 1024, 16384

# kernel-name substrings of each wrapper's kernels in the profiler's events
KERNEL_NAMES = {"pairwise_l2": ("pairwise_l2",), "ivf_scan": ("ivf_scan",)}


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def call_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean time of fn() over `iters` back-to-back calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int, names) -> float:
    """Mean device time a call of the kernels whose name holds one of
    `names`, from torch.profiler's kernel events (fn warmed up first)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, seen = 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and any(
                n in e.name for n in names):
            total += e.time_range.end - e.time_range.start
            seen += 1
    if not seen:
        raise RuntimeError(f"profiler saw no kernel named like {names}")
    return total / iters / 1e3


def time_cases(torch, ops, cases) -> list:
    """For each case: launches a call, call_ms, plain_ms and library_ms by
    CUDA events, then device_ms by torch.profiler in a second pass (once
    the profiler has traced the card, every later launch in the process
    pays its callbacks, so no event timing follows it)."""
    out = []
    for c in cases:
        before = dict(ops.LAUNCHES)
        c["fn"]()
        torch.cuda.synchronize()
        out.append({"launches": sum(ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES),
                    "call_ms": call_ms(torch, c["fn"], c["iters"]),
                    "plain_ms": call_ms(torch, c["plain"], max(2, c["iters"] // 10), 1),
                    "library_ms": call_ms(torch, c["library"], max(2, c["iters"] // 10), 1)})
    for c, r in zip(cases, out):
        r["device_ms"] = device_ms(torch, c["fn"], c["iters"], KERNEL_NAMES[c["kernel"]])
    return out


def _valid_sample(torch, cand, width: int, gen):
    """(B, width) int32: `width` valid ids of each row of cand, drawn at
    random (an IVF-PQ shortlist's rows lie in the probed lists)."""
    w = (cand >= 0).float()
    pos = torch.multinomial(w, width, replacement=False, generator=gen)
    return torch.gather(cand, 1, pos).contiguous()


def cases(torch, ops, ref, catalog, reqs, ivf_index, codebooks, dev, wide=True,
          shortlist=None):
    """The main-path shapes as dicts: kernel (the wrapper family timed),
    label, shape, key ((counter, dims) of the launch in
    ops.SHAPE_LAUNCHES, where the tree has it), fn (the call as the tree's
    index makes it), plain (its plain version), library, bound (ms, by),
    main (launched on the serving or LM path), iters.  `shortlist(q)` gives
    the IVF-PQ re-rank's (B, refine * k) ids (None: a random sample of the
    probed ids)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n, d = catalog.shape
    out = []

    def add(kernel, label, shape, key, fn, plain, library, bnd, main=True, iters=50):
        out.append({"kernel": kernel, "label": label, "shape": shape, "key": key, "fn": fn,
                    "plain": plain, "library": library, "bound": bnd, "main": main,
                    "iters": iters})

    def l2(label, q, x, main=True, iters=50):
        nq, nx, dd = q.shape[0], x.shape[0], q.shape[1]
        add("pairwise_l2", label, f"Q={nq} N={nx} D={dd}", ("pairwise_l2", (nq, nx, dd)),
            lambda: ops.pairwise_l2(q, x), lambda: ref.pairwise_l2_ref(q, x),
            lambda: torch.cdist(q, x),
            bound_ms(4.0 * (nq * dd + nx * dd + nq * nx), 2.0 * nq * nx * dd), main, iters)

    for b in (64, 8):
        q = reqs[:b].contiguous()
        rows = catalog[torch.randperm(n, device=dev, generator=gen)[:CAP]].contiguous()
        l2(f"cached-row scan B {b}", q, rows)
        l2(f"IVF coarse quantizer B {b}", q, ivf_index.centroids)
        # the PQ tables: one batched launch where the tree has it, else one
        # launch a subspace (the tree's PQCodec.adc_lut)
        m, ksub, dsub = codebooks.shape
        qv = q.view(b, m, dsub).transpose(0, 1)
        subs = [q[:, i * dsub:(i + 1) * dsub].contiguous() for i in range(m)]
        if hasattr(ops, "pairwise_l2_batched"):
            fn = lambda qv=qv: ops.pairwise_l2_batched(qv, codebooks)  # noqa: E731
        else:
            fn = lambda subs=subs: torch.stack(  # noqa: E731
                [ops.pairwise_l2(s, codebooks[i]) for i, s in enumerate(subs)], dim=1)
        add("pairwise_l2", f"PQ tables B {b}", f"Q={b} N={ksub} D={dsub} x M={m}",
            ("pairwise_l2", (b, ksub, dsub, m)), fn,
            lambda subs=subs: torch.stack([ref.pairwise_l2_ref(s, codebooks[i])
                                           for i, s in enumerate(subs)], dim=1),
            lambda qv=qv: torch.cdist(qv, codebooks),
            bound_ms(4.0 * m * (b * dsub + ksub * dsub + b * ksub), 2.0 * m * b * ksub * dsub))
        l2(f"topk_l2 sample bound B {b}", q, catalog[:SAMPLE])

        # ivf_scan: the IVF probe over the index's lists, and the IVF-PQ
        # re-rank of a (B, refine * k) shortlist
        cand = ivf_index.probe_table(q)
        p = cand.shape[1]
        nvalid = int((cand >= 0).sum())
        ndistinct = int(torch.unique(cand[cand >= 0]).numel())
        if hasattr(ops, "ivf_scan_lists"):
            probe = ivf_index.probe_lists(q)
            fn = lambda q=q, probe=probe: ops.ivf_scan_lists(  # noqa: E731
                q, catalog, ivf_index.invlists, probe, K_REMOTE, lens=ivf_index.lens)
            key = ("ivf_scan_lists", (b, probe.shape[1], ivf_index.invlists.shape[1], d,
                                      K_REMOTE))
            # list-major: each distinct row and its id once, the probe
            # table, the list lengths, the queries, the output
            nbytes = 4.0 * (ndistinct * (d + 1) + probe.numel() + ivf_index.lens.numel()
                            + b * d) + 8.0 * b * K_REMOTE
        else:
            fn = lambda q=q, cand=cand: ops.ivf_scan_topk(q, catalog, cand, K_REMOTE)  # noqa: E731
            key = ("ivf_scan", (b, p, d, K_REMOTE))
            # per query: each distinct row once, the (B, P) table, the
            # queries, the output
            nbytes = 4.0 * (ndistinct * d + b * p + b * d) + 8.0 * b * K_REMOTE

        def lib_scan(q, cand):
            rows_ = catalog[cand.clamp_min(0).long()]
            dd = torch.cdist(q[:, None, :], rows_)[:, 0].masked_fill(cand < 0, float("inf"))
            return torch.topk(dd, K_REMOTE, largest=False)

        add("ivf_scan", f"IVF probe B {b}",
            f"B={b} P={p} valid={nvalid} distinct={ndistinct} D={d} k={K_REMOTE}", key, fn,
            lambda q=q, cand=cand: ref.ivf_scan_ref(q, catalog, cand, K_REMOTE),
            lambda q=q, cand=cand: lib_scan(q, cand),
            bound_ms(nbytes, 3.0 * nvalid * d), iters=20)
        if shortlist is None:
            short = _valid_sample(torch, cand, REFINE * K_REMOTE, gen)
        else:
            short = shortlist(q).to(torch.int32).contiguous()
        nvalid = int((short >= 0).sum())
        ndistinct = int(torch.unique(short[short >= 0]).numel())
        add("ivf_scan", f"IVF-PQ re-rank B {b}",
            f"B={b} P={short.shape[1]} valid={nvalid} distinct={ndistinct} D={d} "
            f"k={K_REMOTE}", ("ivf_scan", (b, short.shape[1], d, K_REMOTE)),
            lambda q=q, short=short: ops.ivf_scan_topk(q, catalog, short, K_REMOTE),
            lambda q=q, short=short: ref.ivf_scan_ref(q, catalog, short, K_REMOTE),
            lambda q=q, short=short: lib_scan(q, short),
            bound_ms(4.0 * (ndistinct * d + short.numel() + b * d) + 8.0 * b * K_REMOTE,
                     3.0 * nvalid * d))
    if wide:
        sem = torch.randn(SEM_N, SEM_D, device=dev, generator=gen)
        qs = torch.randn(64, SEM_D, device=dev, generator=gen)
        l2("topk_l2 sample bound 64 x D 1024", qs, sem[:SAMPLE], main=False)
        for b in (1, 8):
            l2(f"semantic exact scan B {b}", qs[:b].contiguous(), sem, iters=10)
    l2("k-means assignment (build)", catalog, ivf_index.centroids, main=False, iters=3)
    return out


def _forced_probe(ops, nruns):
    """A context in which `ivf_scan_lists` takes the list-major kernel at
    any shape, at `nruns` runs a list (None: as planned)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = ops.ivf_probe_kernel_for, ops.ivf_lists_plan
        ops.ivf_probe_kernel_for = lambda *a: "ivf_scan_lists"
        if nruns is not None:
            ops.ivf_lists_plan = lambda nlist, cap, *a: (nruns, -(-cap // nruns))
        try:
            yield
        finally:
            ops.ivf_probe_kernel_for, ops.ivf_lists_plan = saved
    return ctx()


def design_cases(torch, ops, catalog, reqs, ivf_index, dev):
    """The designs the wrappers pick between, as dicts (kernel, label,
    shape, fn, iters): pairwise_l2's two tiles where the plan takes the
    64 x 64 one, and the IVF probe's kernels at B 1 to 64."""
    gen = torch.Generator(device=dev).manual_seed(6)
    out = []

    def tile(kind, q, x):
        nq, n, d = q.shape[0], x.shape[0], q.shape[1]
        edge = 64 if kind == "tile64" else 32
        res = torch.empty((nq, n), dtype=torch.float32, device=dev)
        ops._pairwise_launch(q, x, res, nq, n, d, 1, (0, d, 0, n, 0), kind, 0,
                             -(-nq // edge) * -(-n // edge))
        return res

    wide = torch.randn(SAMPLE, SEM_D, device=dev, generator=gen)
    for label, q, x, iters in [
            ("topk_l2 sample bound", reqs[:64].contiguous(), catalog[:SAMPLE], 50),
            ("topk_l2 sample bound D 1024", torch.randn(64, SEM_D, device=dev, generator=gen),
             wide, 50),
            ("k-means assignment", catalog, ivf_index.centroids, 5)]:
        for kind in ("tile64", "tile32"):
            out.append({"kernel": "pairwise_l2", "label": f"{label} {kind}",
                        "shape": f"Q={q.shape[0]} N={x.shape[0]} D={q.shape[1]}",
                        "fn": lambda kind=kind, q=q, x=x: tile(kind, q, x), "iters": iters})
    for b in (1, 2, 4, 8, 16, 32, 64):
        q = reqs[:b].contiguous()
        probe = ivf_index.probe_lists(q)
        cand = ivf_index.probe_table(q)
        shape = f"B={b} P={cand.shape[1]} k={K_REMOTE}"
        out.append({"kernel": "ivf_scan", "label": f"IVF probe B {b} per-query",
                    "shape": shape, "iters": 20,
                    "fn": lambda q=q, cand=cand: ops.ivf_scan_topk(q, catalog, cand,
                                                                   K_REMOTE)})
        for nruns in (None, 1, 2, 3, 4, 5):
            def fn(q=q, probe=probe, nruns=nruns):
                with _forced_probe(ops, nruns):
                    return ops.ivf_scan_lists(q, catalog, ivf_index.invlists, probe,
                                              K_REMOTE, lens=ivf_index.lens)
            runs = "as planned" if nruns is None else f"{nruns} runs a list"
            out.append({"kernel": "ivf_scan", "label": f"IVF probe B {b} list-major {runs}",
                        "shape": shape, "fn": fn, "iters": 20})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--skip-wide", action="store_true",
                    help="leave out the 1M x 1024 shapes")
    ap.add_argument("--designs", action="store_true",
                    help="time the designs the wrappers choose between instead")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_shapes: no CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, str(Path(args.src).resolve()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import trace
    from repro_torch.index.ivf import IVFFlatIndex
    from repro_torch.index.pq import IVFPQIndex
    from repro_torch.kernels import _build, ops, ref

    dev = "cuda"
    t0 = time.perf_counter()
    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"src {args.src}; built in {time.perf_counter() - t0} s; card {card}", flush=True)
    cat, reqs, _ = trace.sift_like(n=N_FULL, d=D_FULL, t=T_FULL, seed=0)
    catalog, reqs = torch.from_numpy(cat).to(dev), torch.from_numpy(reqs).to(dev)
    ivf_index = IVFFlatIndex(catalog, device=dev, **IVF)
    if args.designs:
        cs = design_cases(torch, ops, catalog, reqs, ivf_index, dev)
        # event timings of every case first: the profiler slows later launches
        calls = [call_ms(torch, c["fn"], c["iters"]) for c in cs]
        for c, t in zip(cs, calls):
            own = device_ms(torch, c["fn"], c["iters"], KERNEL_NAMES[c["kernel"]])
            every = device_ms(torch, c["fn"], c["iters"], ("",))
            print(f"design | {c['label']} | {c['shape']} | device_ms={own} "
                  f"device_all_kernels_ms={every} call_ms={t}", flush=True)
        return 0
    pq_index = IVFPQIndex(catalog, device=dev, **IVFPQ)
    shortlist = None
    if hasattr(pq_index, "shortlist"):
        shortlist = lambda q: pq_index.shortlist(q, K_REMOTE)[1]  # noqa: E731
    cs = cases(torch, ops, ref, catalog, reqs, ivf_index, pq_index.codec.codebooks, dev,
               wide=not args.skip_wide, shortlist=shortlist)
    for c, r in zip(cs, time_cases(torch, ops, cs)):
        print(f"{c['kernel']} | {c['label']} | {c['shape']} | device_ms={r['device_ms']} "
              f"call_ms={r['call_ms']} launches={r['launches']} bound_ms={c['bound'][0]} "
              f"({c['bound'][1]}) plain_ms={r['plain_ms']} library_ms={r['library_ms']} "
              f"main_path={c['main']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
