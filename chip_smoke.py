#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. build   — compile every kernel from src/repro_torch/kernels/csrc with nvcc
             (one process per source, in parallel) and print the card;
2. kernels — hold each kernel against its plain PyTorch version on the card
             at the main path's shapes and at ragged / masked cases, and time
             kernel, plain version and a library yardstick;
3. parity  — the n = 2000, d = 16 sift replay (B = 8, flat and IVF) on the
             card and on the CPU through the port with the same injected
             uniforms: NAG must agree to 1e-3;
4. slice   — the batched AÇAI serving step at 1M x 128 (SIFT1M's shape):
             AcaiCache with a flat and an IVF index, B = 8 and 64, with the
             launch counts of every kernel read around each run.

The last lines are the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.  Without a CUDA card, or run from a directory
without the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FMA-unit FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# the slice's configuration: benchmarks/churn_bench.py's 1M x 128 cell
N_FULL, D_FULL, T_FULL = 1_000_000, 128, 2048
H_FULL, K_FULL, C_REMOTE, C_LOCAL = 400, 10, 64, 16
IVF_FULL = {"nlist": 256, "nprobe": 16, "train_iters": 4}

# the PyTorch calls timed as each kernel's library yardstick (`library_ms`)
LIBRARY = {
    "pairwise_l2": "torch.cdist (euclidean, one call)",
    "l2_topk": "torch.topk(torch.cdist(q, x), k, largest=False)",
    "ivf_scan": "gather x[cand], torch.cdist, masked torch.topk",
}

KERNEL_META = {
    "pairwise_l2": ("src/repro_torch/kernels/csrc/pairwise_l2.cu",
                    "src/repro/kernels/l2.py:48"),
    "l2_topk": ("src/repro_torch/kernels/csrc/l2_topk.cu",
                "src/repro/kernels/l2_topk.py:103"),
    "ivf_scan": ("src/repro_torch/kernels/csrc/ivf_scan.cu",
                 "src/repro/kernels/ivf_scan.py:84"),
}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events."""
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


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, what, got, want, ids=None):
    """max |got - want| over finite distances; the -1 / +inf pattern and,
    when ids are given, every id whose reference margin to both neighbours
    exceeds the tolerance must be equal.  Returns the max abs error."""
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        raise AssertionError(f"{what}: +inf pattern differs")
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    scale = max(1.0, float(want[fin].abs().max())) if bool(fin.any()) else 1.0
    tol = 1e-5 * scale
    if err > tol:
        raise AssertionError(f"{what}: max abs err {err} > {tol}")
    if ids is not None:
        gi, wi = ids
        if not torch.equal(gi == -1, wi == -1):
            raise AssertionError(f"{what}: -1 slots differ")
        w = torch.where(fin, want, torch.full_like(want, 1e30))
        gap = w[:, 1:] - w[:, :-1]
        inf = torch.full_like(w[:, :1], float("inf"))
        margin = torch.minimum(torch.cat([inf, gap], 1), torch.cat([gap, inf], 1))
        decided = margin > tol + 1e-5 * w.abs()
        bad = int((decided & (gi != wi)).sum())
        if bad:
            raise AssertionError(f"{what}: {bad} decided ids differ")
        log(f"  {what}: max_abs_err={err} tol={tol} decided_ids="
            f"{int(decided.sum())}/{decided.numel()}")
    else:
        log(f"  {what}: max_abs_err={err} tol={tol}")
    return err


def kernel_phase(torch, ops, ref, catalog, reqs, ivf_index, dev):
    """Each kernel against its plain version; returns the JSON rows."""
    errs = {name: 0.0 for name in KERNEL_META}
    g = torch.Generator(device=dev).manual_seed(1)

    log("kernels: ragged and masked cases")
    for (q, n, d) in [(4, 100, 16), (37, 513, 24), (1, 2000, 32), (130, 129, 8)]:
        qa = torch.randn(q, d, device=dev, generator=g)
        xa = torch.randn(n, d, device=dev, generator=g)
        errs["pairwise_l2"] = max(errs["pairwise_l2"], compare(
            torch, f"pairwise_l2 {q}x{n}x{d}", ops.pairwise_l2(qa, xa),
            ref.pairwise_l2_ref(qa, xa)))
        for k in (1, 10, 64, 128):
            if k > n:
                continue
            gd, gi = ops.topk_l2(qa, xa, k)
            wd, wi = ref.l2_topk_ref(qa, xa, k)
            errs["l2_topk"] = max(errs["l2_topk"], compare(
                torch, f"l2_topk {q}x{n}x{d} k={k}", gd, wd, (gi, wi)))
        valid = torch.rand(n, device=dev, generator=g) < 0.05  # underflows at k=64
        gd, gi = ops.topk_l2(qa, xa, 64, valid=valid)
        wd, wi = ref.l2_topk_ref(qa, xa, 64, valid)
        errs["l2_topk"] = max(errs["l2_topk"], compare(
            torch, f"l2_topk tombstones {q}x{n}", gd, wd, (gi, wi)))
    for (b, n, p, d) in [(4, 200, 64, 16), (5, 300, 37, 16), (12, 500, 130, 32),
                         (1, 100, 9, 8)]:
        qa = torch.randn(b, d, device=dev, generator=g)
        xa = torch.randn(n, d, device=dev, generator=g)
        cand = torch.randint(0, n, (b, p), device=dev, generator=g, dtype=torch.int32)
        cand[torch.rand(b, p, device=dev, generator=g) < 0.3] = -1
        valid = torch.rand(n, device=dev, generator=g) < 0.8
        for k in (1, 10, 64, 128):  # k > P pads with +inf / -1
            gd, gi = ops.ivf_scan_topk(qa, xa, cand, k, valid=valid)
            wd, wi = ref.ivf_scan_ref(qa, xa, cand, k, valid)
            errs["ivf_scan"] = max(errs["ivf_scan"], compare(
                torch, f"ivf_scan {b}x{p} k={k}", gd, wd, (gi, wi)))
    # ties across warps and blocks: small-integer data makes every distance
    # exact, and P > N repeats ids, so equal distances abound; the lowest
    # position must win each tie, as in the plain version's stable sort
    qa = torch.randint(-3, 4, (3, 16), device=dev, generator=g).float()
    xa = torch.randint(-3, 4, (1000, 16), device=dev, generator=g).float()
    cand = torch.randint(-1, 1000, (3, 9000), device=dev, generator=g,
                         dtype=torch.int32)
    for k in (1, 10, 64, 128):
        gd, gi = ops.ivf_scan_topk(qa, xa, cand, k)
        wd, wi = ref.ivf_scan_ref(qa, xa, cand, k)
        if not (torch.equal(gd, wd) and torch.equal(gi, wi)):
            raise AssertionError(f"ivf_scan ties k={k}: differs from the plain version")
    log("  ivf_scan ties 3x9000 k=1,10,64,128: equal to the plain version")

    log("kernels: main-path shapes (1M x 128, k = c_remote = 64)")
    rows, extra = {}, []
    n, d = catalog.shape
    for b in (8, 64):
        q = reqs[:b].contiguous()
        # l2_topk: FlatIndex.query
        gd, gi = ops.topk_l2(q, catalog, C_REMOTE)
        wd, wi = ref.l2_topk_ref(q, catalog, C_REMOTE)
        errs["l2_topk"] = max(errs["l2_topk"], compare(
            torch, f"l2_topk B={b}", gd, wd, (gi, wi)))
        t_k = time_ms(torch, lambda: ops.topk_l2(q, catalog, C_REMOTE), 20)
        t_p = time_ms(torch, lambda: ref.l2_topk_ref(q, catalog, C_REMOTE), 3, 1)
        t_l = time_ms(torch, lambda: torch.topk(torch.cdist(q, catalog), C_REMOTE,
                                                largest=False), 5, 1)
        bnd = bound_ms(4.0 * (n * d + b * d) + 8.0 * b * C_REMOTE, 2.0 * b * n * d)
        extra.append(("l2_topk", b, f"Q={b} N={n} D={d} k={C_REMOTE}", t_k, t_p, t_l, bnd))

        # ivf_scan: the IVF probe's table from the real index
        cand = ivf_index.probe_table(q)
        p = cand.shape[1]
        nvalid = int((cand >= 0).sum())
        ndistinct = int(torch.unique(cand[cand >= 0]).numel())
        _, nchunks = ops.ivf_scan_chunks(b, p, C_REMOTE)
        log(f"  ivf_scan B={b}: {nchunks} blocks a query keep "
            f"{nchunks * C_REMOTE} of P={p} slots for the merge")
        if nchunks * C_REMOTE >= p:
            raise AssertionError(f"ivf_scan B={b}: the kernel selects nothing")
        gd, gi = ops.ivf_scan_topk(q, catalog, cand, C_REMOTE)
        wd, wi = ref.ivf_scan_ref(q, catalog, cand, C_REMOTE)
        errs["ivf_scan"] = max(errs["ivf_scan"], compare(
            torch, f"ivf_scan B={b} P={p}", gd, wd, (gi, wi)))
        t_k = time_ms(torch, lambda: ops.ivf_scan_topk(q, catalog, cand, C_REMOTE), 20)
        t_p = time_ms(torch, lambda: ref.ivf_scan_ref(q, catalog, cand, C_REMOTE), 3, 1)

        def lib_ivf():
            rows_ = catalog[cand.clamp_min(0).long()]                 # (B, P, D)
            dd = torch.cdist(q[:, None, :], rows_)[:, 0]
            dd = dd.masked_fill(cand < 0, float("inf"))
            return torch.topk(dd, C_REMOTE, largest=False)

        t_l = time_ms(torch, lib_ivf, 3, 1)
        # bytes: each distinct named row once, the table, queries and output
        bnd = bound_ms(4.0 * (ndistinct * d + b * p + b * d) + 8.0 * b * C_REMOTE,
                       3.0 * nvalid * d)
        extra.append(("ivf_scan", b, f"B={b} P={p} valid={nvalid} "
                      f"distinct={ndistinct} D={d} k={C_REMOTE}",
                      t_k, t_p, t_l, bnd))

        # pairwise_l2: the cached-row scan (B x 2h+64 gathered rows)
        cap = 2 * H_FULL + 64
        rows_c = catalog[torch.randperm(n, device=dev, generator=g)[:cap]].contiguous()
        errs["pairwise_l2"] = max(errs["pairwise_l2"], compare(
            torch, f"pairwise_l2 B={b} x {cap}", ops.pairwise_l2(q, rows_c),
            ref.pairwise_l2_ref(q, rows_c)))
        t_k = time_ms(torch, lambda: ops.pairwise_l2(q, rows_c), 50)
        t_p = time_ms(torch, lambda: ref.pairwise_l2_ref(q, rows_c), 50)
        t_l = time_ms(torch, lambda: torch.cdist(q, rows_c), 50)
        bnd = bound_ms(4.0 * (b * d + cap * d + b * cap), 2.0 * b * cap * d)
        extra.append(("pairwise_l2", b, f"Q={b} N={cap} D={d}", t_k, t_p, t_l, bnd))

    # pairwise_l2 at its largest main-path call: the k-means assignment step
    cents = ivf_index.centroids
    sub = catalog[:65536].contiguous()
    errs["pairwise_l2"] = max(errs["pairwise_l2"], compare(
        torch, "pairwise_l2 65536 x 256", ops.pairwise_l2(sub, cents),
        ref.pairwise_l2_ref(sub, cents)))
    nc = cents.shape[0]
    t_k = time_ms(torch, lambda: ops.pairwise_l2(catalog, cents), 5, 1)
    t_p = time_ms(torch, lambda: ref.pairwise_l2_ref(catalog, cents), 5, 1)
    t_l = time_ms(torch, lambda: torch.cdist(catalog, cents), 5, 1)
    bnd = bound_ms(4.0 * (n * d + nc * d + n * nc), 2.0 * n * nc * d)
    extra.append(("pairwise_l2", "kmeans", f"Q={n} N={nc} D={d}", t_k, t_p, t_l, bnd))

    for name, b, shape, t_k, t_p, t_l, (bms, by) in extra:
        log(f"  time {name} [{shape}]: kernel_ms={t_k} plain_ms={t_p} "
            f"library_ms={t_l} bound_ms={bms} ({by})")
        if b == 64:
            rows[name] = {"name": name, "route": "cuda",
                          "source": KERNEL_META[name][0],
                          "replaces": KERNEL_META[name][1],
                          "launches": 0, "max_abs_err": errs[name],
                          "ms": t_k, "plain_ms": t_p, "bound_ms": bms,
                          "bound_by": by, "library_ms": t_l,
                          "library": LIBRARY[name], "shape": shape}
    return rows


def parity_phase(torch, ops, dev):
    """n = 2000, d = 16 sift replay on the card and on the CPU, same uniforms."""
    from repro_torch import convert
    from repro_torch.core import oma, policy, trace
    from repro_torch.core.costs import calibrate_fetch_cost
    from repro_torch.index.candidates import index_candidate_fn_batched
    from repro_torch.index.exact import FlatIndex
    from repro_torch.index.ivf import IVFFlatIndex

    n, t, b = 2000, 2048, 8
    cat, reqs, _ = trace.sift_like(n=n, d=16, t=t, seed=0)
    c_f = calibrate_fetch_cost(cat, kth=50, sample=256, device="cpu")
    cfg = policy.AcaiConfig(h=64, k=8, c_f=c_f, c_remote=32, c_local=16,
                            oma=oma.OMAConfig(eta=0.05 / c_f))
    cpu_ivf = IVFFlatIndex(cat, nlist=48, nprobe=10, device="cpu")
    uniforms = torch.rand(t // b, n, generator=torch.Generator().manual_seed(7))
    state0 = policy.init_state(n, cfg, seed=0, device="cpu")
    for kind in ("flat", "ivf"):
        out = {}
        for where in ("cpu", dev):
            catalog = torch.from_numpy(cat).to(where)
            if kind == "flat":
                index = FlatIndex(cat, device=where)
            else:
                index = convert.ivf_from_numpy(cat, cpu_ivf.centroids.numpy(),
                                               cpu_ivf.invlists.numpy(), 10, device=where)
            fn = index_candidate_fn_batched(index, catalog, 32, 16, h=64)
            step = policy.make_step_batched(cfg, fn, b)
            state = convert.cache_state_from_numpy(state0.y.numpy(), state0.x.numpy(),
                                                   0, device=where)
            ops.reset_launches()
            gains, xs = [], []
            rq = torch.from_numpy(reqs).to(where)
            for i in range(t // b):
                state, m = step(state, rq[i * b:(i + 1) * b], uniforms[i].to(where))
                gains.append(m.gain_int)
                xs.append(state.x.cpu())
            if where != "cpu":
                torch.cuda.synchronize()
                counts = dict(ops.LAUNCHES)
                need = ("l2_topk",) if kind == "flat" else ("ivf_scan",)
                for name in need + ("pairwise_l2",):
                    if counts[name] == 0:
                        raise AssertionError(f"parity {kind}: {name} never launched")
                log(f"  parity {kind} launches on the card: {counts}")
            out[where] = (float(torch.cat(gains).sum()) / (cfg.k * c_f * t), xs)
        nag_cpu, xs_cpu = out["cpu"]
        nag_gpu, xs_gpu = out[dev]
        same_x = sum(bool(torch.equal(a, bb)) for a, bb in zip(xs_cpu, xs_gpu)) / len(xs_cpu)
        log(f"parity {kind} B={b}: NAG cpu={nag_cpu} cuda={nag_gpu} "
            f"|diff|={abs(nag_cpu - nag_gpu)} share_of_steps_x_equal={same_x}")
        if not abs(nag_cpu - nag_gpu) < 1e-3:
            raise AssertionError(f"parity {kind}: NAG differs by more than 1e-3")


def slice_phase(torch, ops, catalog_np, reqs_np, dev):
    """The 1M x 128 serving runs; returns the summed launch counts."""
    from repro_torch.core import oma, policy
    from repro_torch.core.costs import calibrate_fetch_cost
    from repro_torch.index.base import IndexSpec

    t0 = time.perf_counter()
    c_f = calibrate_fetch_cost(catalog_np, kth=50, device=dev)
    log(f"slice: c_f={c_f} (calibrate_fetch_cost kth=50, "
        f"{time.perf_counter() - t0} s)")
    cfg = policy.AcaiConfig(h=H_FULL, k=K_FULL, c_f=c_f, c_remote=C_REMOTE,
                            c_local=C_LOCAL, oma=oma.OMAConfig(eta=0.05 / c_f))
    t0 = time.perf_counter()
    state0 = policy.init_state(N_FULL, cfg, seed=0, device=dev)
    log(f"slice: init_state (host DepRound over 1M) {time.perf_counter() - t0} s, "
        f"occupancy {float(state0.x.sum())}")
    reqs = torch.from_numpy(reqs_np).to(dev)
    total = {name: 0 for name in ops.LAUNCHES}
    for spec in (IndexSpec("flat"), IndexSpec("ivf", IVF_FULL)):
        for b in (8, 64):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache = policy.AcaiCache(catalog_np, dataclasses.replace(cfg, index=spec),
                                     device=dev, state=policy.copy_state(state0))
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gains, served, occ = [], [], None
            for i in range(0, T_FULL, b):
                m = cache.serve_update_batch(reqs[i:i + b])
                gains.append(m.gain_int)
                served.append(m.served_local)
                occ = m.occupancy
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = dict(ops.LAUNCHES)
            g = torch.cat(gains)
            if g.shape != (T_FULL,) or not bool(torch.isfinite(g).all()):
                raise AssertionError("slice: gains not finite or of the wrong shape")
            nag = cache.normalized_gain(float(g.sum()), T_FULL)
            if not 0.0 <= nag <= 1.0:
                raise AssertionError(f"slice: NAG {nag} outside [0, 1]")
            need = ("l2_topk",) if spec.backend == "flat" else ("ivf_scan",)
            for name in need + ("pairwise_l2",):
                if counts[name] == 0:
                    raise AssertionError(f"slice {spec.backend} B={b}: {name} "
                                         f"never launched")
            for name in total:
                total[name] += counts[name]
            log(f"slice {spec.backend} B={b}: requests/s={T_FULL / dt} "
                f"us/request={dt / T_FULL * 1e6} NAG={nag} "
                f"served_local/request={float(torch.cat(served).float().mean())} "
                f"occupancy={float(occ[-1])} build_s={build_s} serve_s={dt} "
                f"launches={counts}")
    return total


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run from the "
              f"repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — the port's smoke test runs on the "
              "card only", file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import trace
    from repro_torch.index.ivf import IVFFlatIndex
    from repro_torch.kernels import _build, ops, ref

    dev = "cuda"
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    card = card_line()
    log(f"card: {card}")

    t0 = time.perf_counter()
    report = _build.build()
    log(f"build: {time.perf_counter() - t0} s for {len(report)} libraries")
    for name, r in report.items():
        log(f"  {name}: {r['seconds']} s: {r['cmd']}")
        log("    " + "\n    ".join(line for line in r["log"].splitlines()
                                   if "registers" in line or "spill" in line))

    t0 = time.perf_counter()
    cat_np, reqs_np, _ = trace.sift_like(n=N_FULL, d=D_FULL, t=T_FULL, seed=0)
    catalog = torch.from_numpy(cat_np).to(dev)
    reqs = torch.from_numpy(reqs_np).to(dev)
    log(f"data: sift_like {N_FULL} x {D_FULL}, {T_FULL} requests "
        f"({time.perf_counter() - t0} s)")
    t0 = time.perf_counter()
    ivf_index = IVFFlatIndex(catalog, device=dev, **IVF_FULL)
    torch.cuda.synchronize()
    log(f"data: IVF index for the kernel phase, longest list "
        f"{ivf_index.invlists.shape[1]} ({time.perf_counter() - t0} s)")

    rows = kernel_phase(torch, ops, ref, catalog, reqs, ivf_index, dev)
    del ivf_index
    parity_phase(torch, ops, dev)
    launches = slice_phase(torch, ops, cat_np, reqs_np, dev)
    for name, row in rows.items():
        row["launches"] = launches[name]
        if row["launches"] == 0:
            raise AssertionError(f"{name} was never launched on the main path")
    log(f"total: {time.perf_counter() - t_start} s")
    print(json.dumps({"kernels": [rows[n] for n in KERNEL_META]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
