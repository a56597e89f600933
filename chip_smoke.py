#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. build   — compile every kernel from src/repro_torch/kernels/csrc with nvcc
             (one process per source, in parallel) and print the card;
2. kernels — hold each kernel against its plain PyTorch version on the card
             at the main path's shapes and at ragged / masked cases (and
             `l2_topk` where its k-th slot ties the (k+1)-th row, and at
             k > N, where it pads with +inf / -1): `pq_adc` and
             `pq_adc_lists` must be bitwise equal to their plain versions
             (`pq_adc_lists`, the IVF-PQ shortlist, also at ragged cases and
             on duplicate code rows whose ties straddle the kk-th slot),
             `ivf_scan_lists` equal to it on small-integer ties;
             every kernel gets one row for each main-path shape
             (scripts/kernel_shapes.py's cases; the per-query `pq_adc`,
             off the main path now, keeps its rows for comparison), with the
             kernel's device time (torch.profiler) beside the call's (CUDA
             events), bound, plain version and a library yardstick, taken
             last, after phase 8 (the profiler slows every later launch of
             the process);
3. parity  — the n = 2000, d = 16 sift replay (B = 8; flat, IVF, IVF-PQ,
             LSH and NSW at benchmarks/backends_bench.py's settings) on the
             card and on the CPU through the port with the same injected
             uniforms: NAG must agree to 1e-3;
4. slice   — the batched AÇAI serving step at 1M x 128 (SIFT1M's shape):
             AcaiCache with a flat, an IVF and an IVF-PQ index, B = 8 and
             64, with the launch counts of every kernel read around each run
             (IVF: one `ivf_scan_lists` launch a step; IVF-PQ: one
             `pq_adc_lists` launch and no `pq_adc` one a step, and three
             `pairwise_l2` launches, the PQ tables one of them);
5. policies — the policy registry, the five baselines and the experiments
             harness (`repro_torch.experiments`): BENCH_experiments.json's
             24 rows replayed on the card (`--from-bench`; baselines within
             1e-3 of the reference's NAG, AÇAI within 0.03 of the file),
             its sift_like AÇAI row on the card and on the CPU with the
             same uniforms (NAG to 1e-3), then the experiments grid's six
             policies at the slice's 1M x 128 over one shared server oracle
             (exactly 4 `l2_topk` launches at 512 x 1M x 128, k 128, for
             the precompute, none inside any replay; occupancy <= h; NAG
             finite) and SIM-LRU again with an online oracle (one `l2_topk`
             launch a batch of 8, NAG within 1e-3 of the precomputed run);
6. churn   — the mutable catalog (benchmarks/churn_bench.py --full's
             configuration): a rolling_catalog trace of 1M x 128 (half live,
             churn 0.1: 205 insert + expire events over 2048 requests), AÇAI
             through `build_policy` and `replay_with_churn` on the card, exact
             and over the flat, IVF and IVF-PQ indexes, IVF also with refresh
             every 1024 requests, exact and IVF with compaction every 512;
             the exact rows' NAG within 0.02 of BENCH_churn_full.json's
             (0.6858; 0.6852 compacted; the port draws its own uniforms), the
             IVF rows' differences printed; the exact replay run twice gives
             the same NAG to the last digit; the n 2000 x 16 trace
             (BENCH_churn.json's size) for all five backends with refresh and
             compaction on the card and on the CPU with the same uniforms and
             initial rows (NAG to 1e-3); the masked kernels against their
             plain versions where the sample region of `l2_topk`'s bound is
             all tombstoned, and after an append that doubles an IVF and an
             IVF-PQ table's columns, with tombstones inside lists; and no
             mutation at a fixed capacity reallocating a slab, mask or table;
7. flash   — `flash_attention` against its plain version on the card: f32
             at tests/test_kernels.py's five shapes (<= 1e-4, the float32
             FMA kernel) and bf16 (within 2^-8 of the output, the wgmma
             kernel) at the LM path's prefill shapes, ragged edge cases and
             three full-width shapes, these timed (logged) with bound,
             plain version, the FMA kernel it replaced there, and
             scaled_dot_product_attention as the library yardstick (with
             the same boolean mask, and with is_causal where the mask is
             plain causal); and `l2_topk` at 64 x 1M x 1024 (the semantic
             tier's width) and 64 x 1M x 4096 (yi-6b's);
8. lm parity — qwen1.5-0.5b SMOKE in float32 with the flash path forced
             (flash_threshold 32, flash_chunk 16), card against the CPU
             port on the same weights and uniforms: generate tokens and
             ServeEngine outputs equal, SemanticCachedLM NAG to 1e-3;
9. lm slice — qwen1.5-0.5b at full width through
             `repro_torch.launch.serve.main`: continuous batching of 8
             prompts of 2048-8000 tokens over an 8192-token cache, then the
             semantic tier over a 1M x 1024 catalog of earlier prompts'
             embeddings under the exact and the flat index (requests repeat
             catalog prompts with the paper's Zipf(0.9) popularity); every
             prefill, the engine's and each generation's on a miss, must
             launch the wgmma flash kernel once a layer, and the FMA one
             never.

The churn path's kernel rows (masked `l2_topk` over the slab, AÇAI's exact
scan over it, the add-time assignment, the masked IVF probe and IVF-PQ
shortlist on appended lists) count the churn phase's launches; the other
rows the slice's, policies' and LM slice's.

The last lines are the kernels JSON (one row a main-path shape of every
kernel, with that shape's launches on the main path; the per-query pq_adc's
rows, 0 launches, beside pq_adc_lists'), the card's name and power limit,
and {"ok": true, "device": {...}}.  Without a CUDA card, or run from a
directory without the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from collections import Counter
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FMA-unit FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12  # dense TF32 tensor-core rate (l2_topk's products)
BF16_FLOPS = 989e12  # dense bf16 tensor-core rate

# the slice's configuration: benchmarks/churn_bench.py's 1M x 128 cell
N_FULL, D_FULL, T_FULL = 1_000_000, 128, 2048
H_FULL, K_FULL, C_REMOTE, C_LOCAL = 400, 10, 64, 16
IVF_FULL = {"nlist": 256, "nprobe": 16, "train_iters": 4}
# IVF-PQ: the same coarse layer; m and refine are backends_bench.py's
IVFPQ_FULL = {"nlist": 256, "nprobe": 16, "m": 8, "refine": 4}
# the parity replay's backends: benchmarks/backends_bench.py's SPECS
PARITY_SPECS = {"ivf": {"nlist": 48, "nprobe": 10},
                "ivfpq": {"nlist": 48, "nprobe": 10, "m": 8, "refine": 4},
                "lsh": {"tables": 12, "bits": 8},
                "nsw": {"degree": 16, "beam": 48, "steps": 16}}
# l2_topk's k-th slot ties: generator seeds of 64 uniform queries against
# the slice's catalog (found by a search of 200 seeds from 100)
TOPK_TIE_SEEDS = (173, 228)
# the kernels each index's query must launch (pairwise_l2 runs on every
# path: the cached-row scan)
NEEDS = {"flat": ("l2_topk",), "ivf": ("ivf_scan_lists",),
         "ivfpq": ("pq_adc_lists", "ivf_scan"), "lsh": ("ivf_scan",), "nsw": ()}
# launches a serving step must make, by index: the IVF probe is one
# list-major launch (and never the per-query kernel); the IVF-PQ shortlist
# one list-major launch (and never the per-query pq_adc); IVF-PQ launches
# pairwise_l2 three times (coarse quantizer, the batched PQ tables, the
# cached-row scan)
STEP_LAUNCHES = {"ivf": {"ivf_scan_lists": 1, "ivf_scan": 0},
                 "ivfpq": {"pq_adc_lists": 1, "pq_adc": 0, "pairwise_l2": 3}}

# the policies phase: the reference's results file (its rows replayed with
# their own policy dicts), where the reference at HEAD gives another NAG
# than the file (a near-tie of its oracle's answers), and the tolerances
BENCH_EXPERIMENTS = ROOT / "BENCH_experiments.json"
REFERENCE_NAG = {("adversarial", "qcache"): 0.8182}
BASELINE_TOL, ACAI_TOL, CARD_CPU_TOL = 1e-3, 0.03, 1e-3
# the full-width run: the experiments grid's six specs at the slice's h and
# k over one oracle precomputed at kmax 128 (512 queries a launch)
ORACLE_KMAX, ORACLE_BLOCK = 128, 512

# the PyTorch calls timed as each kernel's library yardstick (`library_ms`)
LIBRARY = {
    "pairwise_l2": "torch.cdist (euclidean, one call)",
    "l2_topk": "torch.topk(torch.cdist(q, x), k, largest=False)",
    "ivf_scan": "gather x[cand], torch.cdist, masked torch.topk",
    "ivf_scan_lists": "gather x[table of the probed lists], torch.cdist, masked torch.topk",
    "pq_adc": "torch.gather on the flattened LUT at codes[cand], sum over m",
    "pq_adc_lists": "pq_adc's yardstick over the probed lists' table, then "
                    "torch.topk(kk, largest=False)",
    "flash_attention": "torch.nn.functional.scaled_dot_product_attention with "
                       "the same boolean mask",
}
# logged beside flash_attention's library_ms where the mask is plain causal
# (q_offset 0, no window, keys up to S): PyTorch's flash backend
LIBRARY_CAUSAL = ("scaled_dot_product_attention(is_causal=True) on "
                  "k[:, :written_upto]")

KERNEL_META = {
    "pairwise_l2": ("src/repro_torch/kernels/csrc/pairwise_l2.cu",
                    "src/repro/kernels/l2.py:48"),
    "l2_topk": ("src/repro_torch/kernels/csrc/l2_topk.cu",
                "src/repro/kernels/l2_topk.py:103"),
    "ivf_scan_lists": ("src/repro_torch/kernels/csrc/ivf_scan_lists.cu",
                       "src/repro/kernels/ivf_scan.py:84"),
    "ivf_scan": ("src/repro_torch/kernels/csrc/ivf_scan.cu",
                 "src/repro/kernels/ivf_scan.py:84"),
    "pq_adc_lists": ("src/repro_torch/kernels/csrc/pq_adc_lists.cu",
                     "src/repro/kernels/pq_adc.py:60"),
    "pq_adc": ("src/repro_torch/kernels/csrc/pq_adc.cu",
               "src/repro/kernels/pq_adc.py:60"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
                        "src/repro/kernels/flash_attention.py:100"),
}
# the row of each launch counter, where it is not the counter's name: the LM
# path's flash_attention is the bf16 wgmma kernel; its float32 FMA sibling
# (csrc/flash_attention.cu) takes float32 and D 16 / 32
ROW_OF = {"flash_attention_wgmma": "flash_attention"}

# the LM tier: qwen1.5-0.5b (src/repro/configs/qwen1_5_0_5b.py) at full
# width, random weights from seed 0; an 8192-token cache takes the flash
# path (T >= flash_threshold 8192, T % flash_chunk 2048 == 0)
LM_ARCH, LM_S_MAX = "qwen1.5-0.5b", 8192
LM_COMMON = ["--arch", LM_ARCH, "--s-max", str(LM_S_MAX)]
LM_RUNS = {
    "engine": LM_COMMON + ["--batch", "4", "--requests", "8",
                           "--prompt-len", "2048:8000", "--max-tokens", "16",
                           "--catalog", "0"],
    "semantic exact": LM_COMMON + [
        "--batch", "8", "--requests", "32", "--query-batches", "8",
        "--prompt-len", "512", "--max-tokens", "4", "--catalog", "1000000",
        "--cache-size", "400", "--remote-index", "exact"],
    "semantic flat": LM_COMMON + [
        "--batch", "8", "--requests", "32", "--query-batches", "8",
        "--prompt-len", "512", "--max-tokens", "4", "--catalog", "1000000",
        "--cache-size", "400", "--remote-index", "flat"],
}
# the kernels each semantic-tier index launches: l2_topk in c_f's
# calibration (and the flat scan), pairwise_l2 in the exact candidate scan
# (and the flat path's cached-row scan)
LM_NEEDS = ("pairwise_l2", "l2_topk")
# the engine run's prompt lengths (LM_RUNS["engine"]'s --prompt-len)
ENGINE_PROMPTS = (2048, 8000)

# flash_attention checks: tests/test_kernels.py:101-106's five shapes in
# float32 (b, s, t, h, kv, d, causal, window; q_offset t - s,
# written_upto t), two ragged ones, then three full-width bf16 shapes
# (name, b, s, t, h, kv, d, causal, window, q_offset, written_upto)
FLASH_F32 = [(2, 64, 64, 4, 2, 32, True, 0), (1, 128, 128, 8, 8, 64, True, 0),
             (2, 64, 64, 4, 4, 32, False, 0), (2, 64, 64, 4, 2, 32, True, 24),
             (1, 32, 128, 4, 2, 32, True, 0), (1, 100, 300, 4, 1, 16, True, 0),
             (2, 77, 200, 4, 2, 128, True, 50)]
FLASH_BF16 = [("qwen1.5-0.5b prefill", 1, 4096, 8192, 16, 16, 64, True, 0, 0, 4096),
              ("yi-6b GQA", 1, 4096, 4096, 32, 4, 128, True, 0, 0, None),
              ("window 4096", 1, 8192, 8192, 16, 16, 64, True, 4096, 0, None)]
# checked, not timed: the LM path's own prefill shapes (S prompt tokens into
# an 8192-token cache, written_upto S: the engine's 2048-8000, a semantic
# generation's 512), and ragged S, offsets and written_upto at D 128 and
# with a window, which reach the kernel's edge tiles, TMA's zero fill past
# S and written_upto, and its store guard
FLASH_BF16_EDGE = [("engine prefill S 2049", 1, 2049, 8192, 16, 16, 64, True, 0, 0, 2049),
                   ("engine prefill S 8000", 1, 8000, 8192, 16, 16, 64, True, 0, 0, 8000),
                   ("generation prefill S 512", 1, 512, 8192, 16, 16, 64, True, 0, 0, 512),
                   ("GQA q_offset 1000", 1, 999, 4096, 32, 4, 128, True, 0, 1000, 1999),
                   ("window 1000 q_offset 1500", 2, 777, 3000, 8, 2, 64, True, 1000,
                    1500, 2277),
                   ("not causal, written_upto 700", 1, 300, 1024, 8, 8, 128, False, 0,
                    0, 700)]
# launches by (kernel, shape) over the main path's runs (the slice and the
# LM slice), read from ops.SHAPE_LAUNCHES after each run; the churn phase's
# apart (its rows' shapes repeat the slice's keys)
MAIN_SHAPES: Counter = Counter()
CHURN_SHAPES: Counter = Counter()

# the churn phase: benchmarks/churn_bench.py --full's rolling_catalog (seed
# 17, warm 0.5, churn 0.1, h 400, k 10, B 8) and the reference's NAG there
# (BENCH_churn_full.json), by (index, refresh_every, compact_every)
CHURN_FULL = {"n": N_FULL, "d": D_FULL, "t": T_FULL, "churn_rate": 0.1, "warm": 0.5,
              "seed": 17}
CHURN_CELLS = [("exact", 0, 0), ("flat", 0, 0), ("ivf", 0, 0), ("ivfpq", 0, 0),
               ("ivf", 1024, 0), ("exact", 0, 512), ("ivf", 0, 512)]
CHURN_REF_NAG = {("exact", 0, 0): 0.6858, ("exact", 0, 512): 0.6852, ("ivf", 0, 0): 0.715,
                 ("ivf", 1024, 0): 0.7142, ("ivf", 0, 512): 0.715}
CHURN_NAG_TOL = 0.02
# the n 2000 x 16 card-against-CPU replay (BENCH_churn.json's size, its
# IVF; the other backends at the parity phase's settings)
CHURN_SMALL = {"n": 2000, "d": 16, "t": 2048, "churn_rate": 0.1, "warm": 0.5, "seed": 17}
CHURN_SMALL_SPECS = {"flat": {}, "ivf": {"nlist": 48, "nprobe": 10},
                     "ivfpq": PARITY_SPECS["ivfpq"], "lsh": PARITY_SPECS["lsh"],
                     "nsw": PARITY_SPECS["nsw"]}

# bf16 output against the float32 plain version: the kernel's float32
# result rounded once to bf16 is within 2^-8 of it, relative; the floor
# covers the float32 sums of kernel and plain version (the phase logs how
# far the float32 kernel is from the plain version on the same inputs)
BF16_REL, F32_FLOOR = 2.0 ** -8, 1e-6


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


def bound_ms(nbytes: float, flops: float, peak: float = FP32_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, what, got, want, ids=None):
    """max |got - want| over finite distances; the -1 / +inf pattern and,
    when ids are given, every id whose reference margin to both neighbours
    exceeds the tolerance must be equal.  A top-k's plain version is asked
    for k + 1: its (k+1)-th distance is the k-th slot's right neighbour (a
    row within the tolerance of the k-th may rightly take its place).
    Returns the max abs error."""
    nxt = None
    if ids is not None and want.shape[1] == got.shape[1] + 1:
        want, nxt, ids = want[:, :-1], want[:, -1:], (ids[0], ids[1][:, :-1])
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
        last = inf if nxt is None else torch.nan_to_num(nxt, posinf=1e30) - w[:, -1:]
        margin = torch.minimum(torch.cat([inf, gap], 1), torch.cat([gap, last], 1))
        decided = margin > tol + 1e-5 * w.abs()
        bad = int((decided & (gi != wi)).sum())
        if bad:
            raise AssertionError(f"{what}: {bad} decided ids differ")
        log(f"  {what}: max_abs_err={err} tol={tol} decided_ids="
            f"{int(decided.sum())}/{decided.numel()}")
    else:
        log(f"  {what}: max_abs_err={err} tol={tol}")
    return err


def check_exact(torch, what, got, want) -> float:
    """pq_adc_lists' contract: its (distances, ids) bitwise the plain
    version's, ties included.  Returns the max abs error (0)."""
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"{what}: differs from the plain version (ids equal: "
                             f"{torch.equal(got[1], want[1])}, distances equal: "
                             f"{torch.equal(got[0], want[0])})")
    log(f"  {what}: ids and distances bitwise equal to the plain version")
    return 0.0


def check_bf16(torch, what, got, want) -> float:
    """A bf16 output against the float32 plain version on the same inputs:
    within one bf16 rounding, |got - want| <= 2^-8 |want| + F32_FLOOR.
    Returns the max abs error."""
    diff = (got.float() - want).abs()
    ratio = float((diff / (BF16_REL * want.abs() + F32_FLOOR)).max())
    log(f"  {what}: max_abs_err={float(diff.max())} max err/tolerance={ratio}")
    if not ratio <= 1.0:
        raise AssertionError(f"{what}: error above one bf16 rounding")
    return float(diff.max())


def check_equal(torch, what, got, want) -> float:
    """pq_adc's contract: bitwise the plain version (same LUT, same order
    of adds).  Returns the max abs error over finite slots (0)."""
    if not torch.equal(got, want):
        fin = torch.isfinite(want)
        raise AssertionError(f"{what}: differs from the plain version (+inf "
                             f"pattern equal: {torch.equal(torch.isfinite(got), fin)})")
    log(f"  {what}: bitwise equal to the plain version")
    return 0.0


# ivf_scan_lists' ragged cases: (n, d, nlist, B, nprobe, k), each run with
# list 3 empty, ids tombstoned mid-list, the last query's last probe entry
# naming no list, then with every query (and probe)
# equal to the first, and with `valid` masking rows; the last two have k
# beyond every list and beyond P, and D 33 loads 4-byte pieces
LISTS_CASES = [(20000, 128, 32, 64, 8, 64), (20000, 128, 32, 8, 8, 64),
               (5000, 24, 16, 7, 3, 13), (3000, 33, 40, 5, 40, 128),
               (2000, 1024, 8, 3, 2, 10), (1000, 16, 200, 9, 5, 100)]


# pq_adc_lists' ragged cases: (n, nlist, B, nprobe, kk, M, C, distinct code
# rows (0: all drawn), integer LUT), each run with list 3 empty, ids
# tombstoned mid-list, the first query probing the empty list, the last
# query's last probe entry naming no list, then with `valid` masking rows:
# odd B, kk below and above 128, M 4 (byte loads), kk beyond the probed
# slots, and duplicate code rows (a few distinct ones, and an integer LUT)
# whose ADC ties straddle the kk-th slot
PQ_LISTS_CASES = [(20000, 32, 64, 8, 256, 8, 256, 0, False),
                  (20000, 32, 8, 8, 200, 8, 256, 0, False),
                  (5000, 16, 7, 3, 13, 8, 256, 0, False),
                  (3000, 40, 5, 40, 128, 4, 16, 0, True),
                  (1000, 200, 9, 5, 300, 8, 256, 0, False),
                  (30000, 8, 11, 3, 256, 8, 256, 6, True),
                  (30000, 8, 11, 3, 100, 8, 256, 3, False)]


def pq_lists_checks(torch, ops, ref, dev, g) -> None:
    """`pq_adc_lists` bitwise against its plain version (`ref.pq_shortlist_ref`)
    at PQ_LISTS_CASES."""
    from repro_torch.index.ivf import build_invlists

    for (n, nlist, b, nprobe, kk, m, c, distinct, int_lut) in PQ_LISTS_CASES:
        if distinct:
            pool = torch.randint(0, c, (distinct, m), device=dev, generator=g)
            codes = pool[torch.randint(0, distinct, (n,), device=dev, generator=g)]
        else:
            codes = torch.randint(0, c, (n, m), device=dev, generator=g)
        codes = codes.to(torch.uint8)
        if int_lut:
            lut = torch.randint(0, 6, (b, m, c), device=dev, generator=g).float()
        else:
            lut = torch.rand(b, m, c, device=dev, generator=g) * 10
        assign = torch.randint(0, nlist, (n,), device=dev, generator=g)
        assign[assign == 3] = 4
        inv = torch.from_numpy(build_invlists(assign.cpu().numpy(), nlist)).to(dev)
        inv[inv % 17 == 5] = -1
        probe = torch.stack([torch.randperm(nlist, device=dev, generator=g)[:nprobe]
                             for _ in range(b)]).to(torch.int32)
        probe[0, 0] = 3
        probe[-1, -1] = nlist  # names no list: scans nothing
        cl = ops.codes_by_list(codes, inv)
        valid = torch.rand(n, device=dev, generator=g) < 0.7
        plan = ops.pq_lists_plan(nlist, inv.shape[1], nprobe, kk, m, c, b)
        for v in (None, valid):
            what = (f"pq_adc_lists n={n} nlist={nlist} B={b} nprobe={nprobe} kk={kk} M={m} "
                    f"C={c} distinct={distinct} integer LUT={int_lut} (nruns, run, gmax, qsplit) "
                    f"{plan}{' valid' if v is not None else ''}")
            check_exact(torch, what, ops.pq_shortlist_lists(lut, cl, inv, probe, kk, valid=v),
                        ref.pq_shortlist_ref(lut, cl, inv, probe, kk, v))


def lists_checks(torch, ops, ref, dev, g) -> float:
    """`ivf_scan_lists` against its plain version (the per-query scan of the
    probed lists' table) at LISTS_CASES, and equal to it on small-integer
    ties; returns the max abs error."""
    from repro_torch.index.ivf import build_invlists

    def one(what, q, x, inv, probe, k, valid=None, exact=False):
        # the probed lists' ids; an entry naming no list gives only pad
        p = probe.long()
        inside = ((p >= 0) & (p < inv.shape[0]))[..., None]
        table = torch.where(inside, inv[p.clamp(0, inv.shape[0] - 1)], -1).reshape(
            q.shape[0], -1)
        gd, gi = ops.ivf_scan_lists(q, x, inv, probe, k, valid=valid)
        if exact:
            wd, wi = ref.ivf_scan_ref(q, x, table, k, valid)
            if not (torch.equal(gd, wd) and torch.equal(gi, wi)):
                raise AssertionError(f"{what}: differs from the plain version")
            log(f"  {what}: equal to the plain version")
            return 0.0
        wd, wi = ref.ivf_scan_ref(q, x, table, k + 1, valid)
        return compare(torch, what, gd, wd, (gi, wi))

    err = 0.0
    for (n, d, nlist, b, nprobe, k) in LISTS_CASES:
        x = torch.randn(n, d, device=dev, generator=g)
        q = torch.randn(b, d, device=dev, generator=g)
        assign = torch.randint(0, nlist, (n,), device=dev, generator=g)
        assign[assign == 3] = 4
        inv = torch.from_numpy(build_invlists(assign.cpu().numpy(), nlist)).to(dev)
        inv[inv % 17 == 5] = -1
        probe = torch.stack([torch.randperm(nlist, device=dev, generator=g)[:nprobe]
                             for _ in range(b)]).to(torch.int32)
        probe[0, 0] = 3
        probe[-1, -1] = nlist  # names no list: scans nothing
        what = f"ivf_scan_lists n={n} D={d} nlist={nlist} B={b} nprobe={nprobe} k={k}"
        err = max(err, one(what, q, x, inv, probe, k))
        err = max(err, one(what + " equal queries", q[:1].expand(b, -1).contiguous(), x,
                           inv, probe[:1].expand(b, -1).contiguous(), k))
        valid = torch.rand(n, device=dev, generator=g) < 0.7
        err = max(err, one(what + " valid", q, x, inv, probe, k, valid))
    x = torch.randint(-3, 4, (3000, 16), device=dev, generator=g).float()
    q = torch.randint(-3, 4, (11, 16), device=dev, generator=g).float()
    assign = torch.randint(0, 20, (3000,), device=dev, generator=g)
    inv = torch.from_numpy(build_invlists(assign.cpu().numpy(), 20)).to(dev)
    probe = torch.stack([torch.randperm(20, device=dev, generator=g)[:7]
                         for _ in range(11)]).to(torch.int32)
    for k in (1, 10, 64, 128):
        one(f"ivf_scan_lists ties 11 x 7 lists k={k}", q, x, inv, probe, k, exact=True)
    return err


def shapes_phase(torch, ops, ref, catalog, reqs, ivf_index, pq_index, dev, churn_cases=()):
    """Every kernel at each main-path shape (scripts/kernel_shapes.py's
    cases, then the churn path's): held against the plain version, then
    timed (device and call) with bound, plain version and library call.
    Returns the JSON rows, launches still 0, each with its launch key,
    whether the main path must launch it and whether it is the churn
    path's."""
    import kernel_shapes
    from repro_torch.kernels import _build

    lib = _build.load("pairwise_l2")
    for qm in (1, 2, 4, 8, 16):
        for d in (16, 128, 1024, 1500):
            host = ops.pairwise_l2_skinny_smem_bytes_host(qm, d)
            if host != lib.pairwise_l2_skinny_smem_bytes(qm, d):
                raise AssertionError(f"pairwise_l2 skinny smem at qm={qm} d={d}: host copy "
                                     f"{host}, pairwise_l2.cu {lib.pairwise_l2_skinny_smem_bytes(qm, d)}")
    log("shapes: pairwise_l2's skinny smem formula, host copy equal to the library's")
    lib = _build.load("pq_adc_lists")
    for gmax in (1, 2, 4, 8):
        for (m, c, run, kp) in ((8, 256, 4154, 256), (4, 16, 80, 13), (16, 256, 1000, 1000)):
            host = ops.pq_lists_smem_bytes_host(gmax, m, c, run, kp)
            if host != lib.pq_adc_lists_smem_bytes(gmax, m, c, run, kp):
                raise AssertionError(f"pq_adc_lists smem at {(gmax, m, c, run, kp)}: host copy "
                                     f"{host}, pq_adc_lists.cu "
                                     f"{lib.pq_adc_lists_smem_bytes(gmax, m, c, run, kp)}")
    log("shapes: pq_adc_lists' smem formula, host copy equal to the library's")
    cases = kernel_shapes.cases(torch, ops, ref, catalog, reqs, ivf_index, pq_index, dev)
    n_main = len(cases)
    cases = cases + list(churn_cases)
    errs = []
    for c in cases:
        got, want = c["fn"](), c["plain"]()
        what = f"{c['kernel']} {c['label']} [{c['shape']}]"
        if c["check"] == "exact":
            errs.append(check_exact(torch, what, got, want) if isinstance(got, tuple)
                        else check_equal(torch, what, got, want))
        elif c["check"] == "bf16":
            errs.append(check_bf16(torch, what, got, want))
        else:
            if isinstance(got, tuple):  # a top-k: distances, and the -1 pattern
                if not torch.equal(got[1] == -1, want[1] == -1):
                    raise AssertionError(f"{c['label']}: -1 slots differ")
                got, want = got[0], want[0]
            errs.append(compare(torch, what, got, want))
        del got, want
    rows = []
    for i, (c, err, r) in enumerate(zip(cases, errs, kernel_shapes.time_cases(torch, ops,
                                                                              cases))):
        bms, by = c["bound"]
        log(f"  time {c['kernel']} {c['label']} [{c['shape']}]: device_ms={r['device_ms']} "
            f"device_all_kernels_ms={r['device_all_ms']} call_ms={r['call_ms']} "
            f"launches_a_call={r['launches']} plain_ms={r['plain_ms']} "
            f"library_ms={r['library_ms']} bound_ms={bms} ({by}) main_path={c['main']}")
        if c["row"]:
            counter, dims = c["key"]
            name = ROW_OF.get(counter, counter)
            rows.append({"name": name, "route": "cuda", "source": KERNEL_META[name][0],
                         "replaces": KERNEL_META[name][1], "launches": 0,
                         "max_abs_err": err, "ms": r["device_ms"], "call_ms": r["call_ms"],
                         "device_all_kernels_ms": r["device_all_ms"],
                         "plain_ms": r["plain_ms"], "bound_ms": bms, "bound_by": by,
                         "library_ms": r["library_ms"], "library": LIBRARY[name],
                         "shape": f"{c['label']}: {c['shape']}", "key": [counter, list(dims)],
                         "main": c["main"], "churn": i >= n_main})
    torch.cuda.empty_cache()
    return rows


def shape_launches(counts, counter: str, dims) -> int:
    """Main-path launches of `counter` at `dims`.  A list-major row matches
    any list capacity (the slice's index is built anew): the IVF probe by
    (B, D, k), the IVF-PQ shortlist by (B, nprobe, M, kk); the engine's
    prefill row (timed at one length) counts the engine's prefills, of
    every prompt length it draws (ENGINE_PROMPTS)."""
    if counter == "ivf_scan_lists":
        return sum(v for (k, s), v in counts.items()
                   if k == counter and (s[0], s[3], s[4]) == (dims[0], dims[3], dims[4]))
    if counter == "pq_adc_lists":
        return sum(v for (k, s), v in counts.items()
                   if k == counter and (s[0], s[1], s[3], s[4]) ==
                   (dims[0], dims[1], dims[3], dims[4]))
    if counter == "flash_attention_wgmma" and dims[1] != 512:
        lo, hi = ENGINE_PROMPTS
        return sum(v for (k, s), v in counts.items()
                   if k == counter and lo <= s[1] <= hi and s[0] == dims[0]
                   and tuple(s[2:]) == tuple(dims[2:]))
    return counts.get((counter, tuple(dims)), 0)


def kernel_phase(torch, ops, ref, catalog, reqs, ivf_index, pq_index, dev):
    """Each kernel against its plain version (the timed rows come by shape,
    in shapes_phase)."""
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
            wd, wi = ref.l2_topk_ref(qa, xa, k + 1)
            errs["l2_topk"] = max(errs["l2_topk"], compare(
                torch, f"l2_topk {q}x{n}x{d} k={k}", gd, wd, (gi, wi)))
        valid = torch.rand(n, device=dev, generator=g) < 0.05  # underflows at k=64
        gd, gi = ops.topk_l2(qa, xa, 64, valid=valid)
        wd, wi = ref.l2_topk_ref(qa, xa, 65, valid)
        errs["l2_topk"] = max(errs["l2_topk"], compare(
            torch, f"l2_topk tombstones {q}x{n}", gd, wd, (gi, wi)))
    # k beyond the catalog: k columns on the card as on the CPU, the rows
    # (the live ones) first, then +inf / -1
    qa = torch.randn(2, 4, device=dev, generator=g)
    xa = torch.randn(5, 4, device=dev, generator=g)
    for valid in (None, torch.tensor([True, False, True, True, False], device=dev)):
        gd, gi = ops.topk_l2(qa, xa, 10, valid=valid)
        wd, wi = ref.l2_topk_ref(qa, xa, 10, valid)
        if gd.shape != (2, 10) or gi.shape != (2, 10) or wd.shape != (2, 10):
            raise AssertionError(f"l2_topk k=10 > N=5: shapes {tuple(gd.shape)}, "
                                 f"{tuple(gi.shape)} on the card, {tuple(wd.shape)} plain")
        live = 5 if valid is None else 3
        if not (bool(torch.isinf(gd[:, live:]).all()) and bool((gi[:, live:] == -1).all())):
            raise AssertionError("l2_topk k=10 > N=5: the tail is not +inf / -1")
        errs["l2_topk"] = max(errs["l2_topk"], compare(
            torch, f"l2_topk k=10 > N=5{' valid' if valid is not None else ''}", gd, wd,
            (gi, wi)))
    # each pairwise_l2 design at ragged shapes: skinny (Q <= 16, D % 4 == 0,
    # D past one 64-column stage), the tiles (D % 4 != 0, a catalog off 16
    # bytes), and the batched form over a strided view
    for (q, n, d) in [(5, 1000, 20), (16, 5000, 128), (9, 33, 1024), (2, 3000, 1500),
                      (3, 777, 18), (17, 300, 64)]:
        qa = torch.randn(q, d, device=dev, generator=g)
        xa = torch.randn(n, d, device=dev, generator=g)
        errs["pairwise_l2"] = max(errs["pairwise_l2"], compare(
            torch, f"pairwise_l2 {q}x{n}x{d} ({ops.pairwise_l2_plan(q, n, d)[0]})",
            ops.pairwise_l2(qa, xa), ref.pairwise_l2_ref(qa, xa)))
    xa = torch.randn(3001, 1024, device=dev, generator=g)[1:]
    qa = torch.randn(8, 1024, device=dev, generator=g)
    errs["pairwise_l2"] = max(errs["pairwise_l2"], compare(
        torch, "pairwise_l2 8x3000x1024, catalog off 16 bytes (tile32)",
        ops.pairwise_l2(qa, xa), ref.pairwise_l2_ref(qa, xa)))
    for (m, b, c, dsub) in [(4, 5, 100, 6), (3, 40, 33, 32), (8, 64, 256, 16)]:
        qv = torch.randn(b, m * dsub, device=dev, generator=g).view(b, m, dsub).transpose(0, 1)
        xb = torch.randn(m, c, dsub, device=dev, generator=g)
        errs["pairwise_l2"] = max(errs["pairwise_l2"], compare(
            torch, f"pairwise_l2_batched M={m} B={b} C={c} d={dsub}",
            ops.pairwise_l2_batched(qv, xb), ref.pairwise_l2_batched_ref(qv, xb)))
    for (b, n, p, d) in [(4, 200, 64, 16), (5, 300, 37, 16), (12, 500, 130, 32),
                         (1, 100, 9, 8)]:
        qa = torch.randn(b, d, device=dev, generator=g)
        xa = torch.randn(n, d, device=dev, generator=g)
        cand = torch.randint(0, n, (b, p), device=dev, generator=g, dtype=torch.int32)
        cand[torch.rand(b, p, device=dev, generator=g) < 0.3] = -1
        valid = torch.rand(n, device=dev, generator=g) < 0.8
        for k in (1, 10, 64, 128):  # k > P pads with +inf / -1
            gd, gi = ops.ivf_scan_topk(qa, xa, cand, k, valid=valid)
            wd, wi = ref.ivf_scan_ref(qa, xa, cand, k + 1, valid)
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
    errs["ivf_scan_lists"] = lists_checks(torch, ops, ref, dev, g)
    pq_lists_checks(torch, ops, ref, dev, g)
    # pq_adc at tests/test_kernels.py's four shapes, dense and gathered
    for (q, n, m, c) in [(2, 64, 4, 16), (128, 300, 8, 256), (5, 1000, 16, 256),
                         (1, 50, 2, 4)]:
        lut = torch.rand(q, m, c, device=dev, generator=g)
        codes = torch.randint(0, c, (n, m), device=dev, generator=g, dtype=torch.uint8)
        check_equal(torch, f"pq_adc dense {q}x{n} M={m} C={c}",
                    ops.pq_adc(lut, codes), ref.pq_adc_ref(lut, codes))
        cand = torch.randint(-1, n, (q, 3 * n + 7), device=dev, generator=g,
                             dtype=torch.int32)
        check_equal(torch, f"pq_adc gathered {q}x{3 * n + 7} M={m} C={c}",
                    ops.pq_adc_gather(lut, codes, cand),
                    ref.pq_adc_gather_ref(lut, codes, cand))

    log("kernels: main-path shapes (1M x 128, k = c_remote = 64)")
    n, d = catalog.shape
    for b in (8, 64):
        q = reqs[:b].contiguous()
        # l2_topk: FlatIndex.query
        gd, gi = ops.topk_l2(q, catalog, C_REMOTE)
        wd, wi = ref.l2_topk_ref(q, catalog, C_REMOTE + 1)
        errs["l2_topk"] = max(errs["l2_topk"], compare(
            torch, f"l2_topk B={b}", gd, wd, (gi, wi)))

        # ivf_scan_lists: the IVF probe over the real index's lists
        probe = ivf_index.probe_lists(q)
        cand = ivf_index.invlists[probe.long()].reshape(b, -1)
        gd, gi = ops.ivf_scan_lists(q, catalog, ivf_index.invlists, probe, C_REMOTE,
                                    lens=ivf_index.lens)
        wd, wi = ref.ivf_scan_ref(q, catalog, cand, C_REMOTE + 1)
        errs["ivf_scan_lists"] = max(errs["ivf_scan_lists"], compare(
            torch, f"ivf_scan_lists B={b} P={cand.shape[1]}", gd, wd, (gi, wi)))
        hd, hi = ops.ivf_scan_topk(q, catalog, cand, C_REMOTE)
        log(f"  ivf_scan_lists B={b}: ids equal to the per-query ivf_scan's for "
            f"{float((gi == hi).float().mean())} of slots, max distance difference "
            f"{float((gd - hd).abs().max())}")

        # pq_adc_lists: the IVF-PQ index's shortlist (kk = refine * k), bitwise
        probe = pq_index.probe_lists(q)
        lut = pq_index.codec.adc_lut(q)
        kk = IVFPQ_FULL["refine"] * C_REMOTE
        short = ops.pq_shortlist_lists(lut, pq_index.codes_lists, pq_index.invlists, probe,
                                       kk, lens=pq_index.lens)
        check_exact(torch, f"pq_adc_lists IVF-PQ shortlist B={b} kk={kk} (plan "
                           f"{ops.pq_lists_plan(pq_index.nlist, pq_index.invlists.shape[1], probe.shape[1], kk, *lut.shape[1:], b)})",
                    short, ref.pq_shortlist_ref(lut, pq_index.codes_lists, pq_index.invlists,
                                                probe, kk))
        check_exact(torch, f"pq_adc_lists IVFPQIndex.shortlist B={b}",
                    pq_index.shortlist(q, C_REMOTE), short)

        # ivf_scan: the IVF-PQ re-rank of the ADC shortlist (P = refine * k)
        short = short[1].contiguous()
        gd, gi = ops.ivf_scan_topk(q, catalog, short, C_REMOTE)
        wd, wi = ref.ivf_scan_ref(q, catalog, short, C_REMOTE + 1)
        errs["ivf_scan"] = max(errs["ivf_scan"], compare(
            torch, f"ivf_scan re-rank B={b} P={short.shape[1]} (chunks "
                   f"{ops.ivf_scan_chunks(b, short.shape[1], C_REMOTE)})", gd, wd, (gi, wi)))

        # pq_adc: the per-query ADC scan over the probe table (off the main
        # path since the list-major shortlist; still bitwise)
        cand = pq_index.probe_table(q)
        check_equal(torch, f"pq_adc B={b} P={cand.shape[1]}",
                    ops.pq_adc_gather(lut, pq_index.codes, cand),
                    ref.pq_adc_gather_ref(lut, pq_index.codes, cand))

    # the k-th slot where it ties the (k+1)-th within float32's reach: uniform
    # queries against the catalog (each of these seeds holds queries whose
    # k-th slot the kernel and the plain version fill with different rows,
    # 1e-5 or less apart); float64 distances show which row is nearer
    for seed in TOPK_TIE_SEEDS:
        q = torch.rand(64, d, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
        gd, gi = ops.topk_l2(q, catalog, C_REMOTE)
        wd, wi = ref.l2_topk_ref(q, catalog, C_REMOTE + 1)
        errs["l2_topk"] = max(errs["l2_topk"], compare(
            torch, f"l2_topk k-th slot ties, uniform queries seed {seed}", gd, wd, (gi, wi)))
        for qi in (gi[:, -1] != wi[:, -2]).nonzero()[:, 0].tolist():
            pick = [int(gi[qi, -1]), int(wi[qi, -2]), int(wi[qi, -1])]
            f64 = [float(((catalog[r].double() - q[qi].double()) ** 2).sum()) for r in pick]
            log(f"    query {qi}, k-th slot: kernel row {pick[0]} ({float(gd[qi, -1])}; "
                f"float64 {f64[0]}), plain row {pick[1]} ({float(wd[qi, -2])}; float64 "
                f"{f64[1]}), plain (k+1)-th row {pick[2]} ({float(wd[qi, -1])}; float64 "
                f"{f64[2]})")

    # pq_adc's dense form over the whole catalog's codes (a flat PQ scan)
    q = reqs[:8].contiguous()
    lut, codes = pq_index.codec.adc_lut(q), pq_index.codes
    check_equal(torch, f"pq_adc dense 8x{n}", ops.pq_adc(lut, codes), ref.pq_adc_ref(lut, codes))
    log(f"kernels: max abs errors {errs}")


def parity_phase(torch, ops, dev):
    """n = 2000, d = 16 sift replay on the card and on the CPU, same uniforms."""
    from repro_torch import convert
    from repro_torch.core import oma, policy, trace
    from repro_torch.core.costs import calibrate_fetch_cost
    from repro_torch.index.base import IndexSpec, build_index
    from repro_torch.index.candidates import index_candidate_fn_batched
    from repro_torch.index.exact import FlatIndex

    n, t, b = 2000, 2048, 8
    cat, reqs, _ = trace.sift_like(n=n, d=16, t=t, seed=0)
    c_f = calibrate_fetch_cost(cat, kth=50, sample=256, device="cpu")
    cfg = policy.AcaiConfig(h=64, k=8, c_f=c_f, c_remote=32, c_local=16,
                            oma=oma.OMAConfig(eta=0.05 / c_f))
    built = {kind: build_index(IndexSpec(kind, kw), cat, device="cpu")
             for kind, kw in PARITY_SPECS.items()}

    def load(kind, where):
        """The CPU-built index's structures, on `where`."""
        src = built.get(kind)
        if kind == "flat":
            return FlatIndex(cat, device=where)
        if kind == "ivf":
            return convert.ivf_from_numpy(cat, src.centroids.numpy(),
                                          src.invlists.numpy(), src.nprobe, device=where)
        if kind == "ivfpq":
            return convert.ivfpq_from_numpy(
                cat, src.centroids.numpy(), src.invlists.numpy(),
                src.codec.codebooks.numpy(), src.codes.numpy(), src.nprobe,
                src.refine, device=where)
        if kind == "lsh":
            return convert.lsh_from_numpy(cat, src.planes.numpy(), src.buckets.numpy(),
                                          device=where)
        return convert.nsw_from_numpy(cat, src.graph.numpy(), src.entry_points.numpy(),
                                      src.beam, src.steps, src.expand, device=where)

    uniforms = torch.rand(t // b, n, generator=torch.Generator().manual_seed(7))
    state0 = policy.init_state(n, cfg, seed=0, device="cpu")
    for kind in ("flat",) + tuple(PARITY_SPECS):
        out = {}
        for where in ("cpu", dev):
            catalog = torch.from_numpy(cat).to(where)
            index = load(kind, where)
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
                for name in NEEDS[kind] + ("pairwise_l2",):
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
    for spec in (IndexSpec("flat"), IndexSpec("ivf", IVF_FULL),
                 IndexSpec("ivfpq", IVFPQ_FULL)):
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
            for name in NEEDS[spec.backend] + ("pairwise_l2",):
                if counts[name] == 0:
                    raise AssertionError(f"slice {spec.backend} B={b}: {name} "
                                         f"never launched")
            steps = T_FULL // b
            for name, per_step in STEP_LAUNCHES.get(spec.backend, {}).items():
                if counts[name] != per_step * steps:
                    raise AssertionError(f"slice {spec.backend} B={b}: {name} launched "
                                         f"{counts[name]} times in {steps} steps, expected "
                                         f"{per_step} a step")
            for name in total:
                total[name] += counts[name]
            MAIN_SHAPES.update(ops.SHAPE_LAUNCHES)
            log(f"slice {spec.backend} B={b}: requests/s={T_FULL / dt} "
                f"us/request={dt / T_FULL * 1e6} NAG={nag} "
                f"served_local/request={float(torch.cat(served).float().mean())} "
                f"occupancy={float(occ[-1])} build_s={build_s} serve_s={dt} "
                f"launches={counts}")
    return total


def policies_phase(torch, ops, catalog_np, reqs_np, dev):
    """The policy registry, the baselines and the experiments harness on the
    card: BENCH_experiments.json's grid, the sift_like AÇAI row card
    against CPU, then the six policies at 1M x 128 (launches counted by
    shape into MAIN_SHAPES); returns the full-width run's launch counts."""
    import numpy as np

    from repro_torch import convert
    from repro_torch import experiments as X
    from repro_torch.core import baselines as B
    from repro_torch.core import policy_api as PA
    from repro_torch.core.costs import CostModel, calibrate_fetch_cost
    from repro_torch.core.trace import TraceSpec

    t_phase = time.perf_counter()
    bench = json.loads(BENCH_EXPERIMENTS.read_text())
    t0 = time.perf_counter()
    rows = X.from_bench(bench, device=dev)
    worst = {"baseline": 0.0, "acai": 0.0}
    for r in rows:
        name, trace = r["policy"]["policy"], r["trace"]["name"]
        kind = "acai" if name == "acai" else "baseline"
        want = REFERENCE_NAG.get((trace, name), r["reference_nag"])
        diff = abs(r["nag_full"] - want)
        worst[kind] = max(worst[kind], diff)
        log(f"  policies grid {trace}/{r['label']}: NAG={r['nag_full']} reference={want} "
            f"(file {r['reference_nag']}) |diff|={diff} hit={r['hit_ratio']} "
            f"us/request={r['us_per_request']}")
        if diff > (ACAI_TOL if kind == "acai" else BASELINE_TOL):
            raise AssertionError(f"policies grid {trace}/{r['label']}: NAG {r['nag_full']} "
                                 f"against the reference's {want}")
    log(f"policies: BENCH_experiments.json's {len(rows)} rows on the card in "
        f"{time.perf_counter() - t0} s; max |diff| baselines {worst['baseline']} "
        f"(<= {BASELINE_TOL}), acai {worst['acai']} (<= {ACAI_TOL})")
    if len(rows) != 24:
        raise AssertionError(f"policies grid: {len(rows)} rows, expected 24")

    # the sift_like AÇAI row: one initial state and one set of uniforms,
    # drawn on the CPU, on the card and through the CPU port
    row = next(r for r in bench["rows"] if r["trace"]["name"] == "sift_like"
               and r["policy"]["policy"] == "acai")
    spec = PA.PolicySpec.from_dict(row["policy"])
    cat, reqs = X._get_trace(TraceSpec.from_dict(row["trace"]), {"n": bench["n"],
                                                                  "t": bench["t"]})
    nags = {}
    for where in ("cpu", dev):
        pol = PA.build_policy(spec, cat, None, seed=0, device=where)
        if where == "cpu":
            state0, n = pol.cache.state, cat.shape[0]
            uniforms = torch.rand(bench["t"] // pol.batch, n,
                                  generator=torch.Generator().manual_seed(0))
        pol.cache.state = convert.cache_state_from_numpy(
            state0.y.numpy(), state0.x.numpy(), 0, device=where)
        res = pol.replay(reqs, uniforms=uniforms)
        nags[where] = pol.normalized_gain(res["gain"].sum(), res["requests"])
    diff = abs(nags["cpu"] - nags[dev])
    log(f"policies: sift_like acai row, same state and uniforms: NAG cpu={nags['cpu']} "
        f"cuda={nags[dev]} |diff|={diff} (<= {CARD_CPU_TOL})")
    if diff > CARD_CPU_TOL:
        raise AssertionError("policies: sift_like acai row differs between card and CPU")

    # full width: the experiments grid's six specs at 1M x 128
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c_f = calibrate_fetch_cost(catalog_np, kth=50, sample=256, device=dev)
    log(f"policies 1M: c_f={c_f} (calibrate_fetch_cost kth=50 sample=256, "
        f"{time.perf_counter() - t0} s)")
    specs = X._grid_experiments(c_f, H_FULL, K_FULL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    oracle = B.ServerOracle(catalog_np, reqs_np, kmax=ORACLE_KMAX, device=dev)
    torch.cuda.synchronize()
    key = ("l2_topk", ops.l2_topk_key(ORACLE_BLOCK, N_FULL, D_FULL, ORACLE_KMAX))
    n_pre = -(-T_FULL // ORACLE_BLOCK)
    log(f"policies 1M: oracle precompute {time.perf_counter() - t0} s, "
        f"launches {dict(ops.SHAPE_LAUNCHES)}")
    if ops.SHAPE_LAUNCHES[key] != n_pre or ops.LAUNCHES["l2_topk"] != n_pre + 1:
        raise AssertionError(f"policies 1M: precompute launched l2_topk "
                             f"{ops.SHAPE_LAUNCHES[key]} times at {key[1]} "
                             f"({ops.LAUNCHES['l2_topk']} in all with c_f's), expected "
                             f"{n_pre}")
    tspec = TraceSpec("sift_like", {"n": N_FULL, "d": D_FULL, "t": T_FULL})
    nag = {}
    for spec in specs:
        before = dict(ops.LAUNCHES)
        r = X.run_cell("policies", tspec, spec, catalog_np, reqs_np, oracle, c_f, 50, H_FULL,
                       8, dev)
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before if ops.LAUNCHES[k] != before[k]}
        nag[spec.name] = r["nag_full"]
        log(f"policies 1M {spec.label}: NAG={r['nag_full']} hit_ratio={r['hit_ratio']} "
            f"us/request={r['us_per_request']} p50_step_us={r['p50_step_us']} "
            f"occupancy_mean={r['occupancy_mean']} occupancy_max={r['occupancy_max']} "
            f"local_share={r['local_share']} launches={launched}")
        if not np.isfinite(r["nag_full"]):
            raise AssertionError(f"policies 1M {spec.label}: NAG not finite")
        if launched.get("l2_topk"):
            raise AssertionError(f"policies 1M {spec.label}: l2_topk launched "
                                 f"{launched['l2_topk']} times inside the replay")
        if spec.name != "acai" and r["occupancy_max"] > H_FULL:
            raise AssertionError(f"policies 1M {spec.label}: occupancy "
                                 f"{r['occupancy_max']} > h {H_FULL}")
    best = max(v for k, v in nag.items() if k != "acai")
    log(f"policies 1M: AÇAI's NAG {nag['acai']} is "
        f"{'at least' if nag['acai'] >= best else 'below'} every baseline's (best {best})")

    # SIM-LRU with an online oracle: one l2_topk launch a batch
    sim = next(s for s in specs if s.name == "sim_lru")
    pol = PA.build_policy(sim, catalog_np, CostModel(c_f=c_f), seed=0, device=dev)
    before = ops.LAUNCHES["l2_topk"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = PA.replay_trace(pol, reqs_np, None, batch=8)
    dt = time.perf_counter() - t0
    online = pol.normalized_gain(res["gain"].sum(), res["requests"])
    steps = T_FULL // 8
    log(f"policies 1M sim_lru online oracle: NAG={online} (precomputed {nag['sim_lru']}, "
        f"|diff|={abs(online - nag['sim_lru'])}) us/request={dt / T_FULL * 1e6} "
        f"l2_topk launches={ops.LAUNCHES['l2_topk'] - before} for {steps} batches")
    if ops.LAUNCHES["l2_topk"] - before != steps:
        raise AssertionError("policies 1M: the online oracle did not launch l2_topk once "
                             "a batch")
    if abs(online - nag["sim_lru"]) > 1e-3:
        raise AssertionError("policies 1M: online and precomputed SIM-LRU NAG differ")
    MAIN_SHAPES.update(ops.SHAPE_LAUNCHES)
    log(f"policies: phase {time.perf_counter() - t_phase} s")
    del oracle, pol
    torch.cuda.empty_cache()
    return dict(ops.LAUNCHES)


def churn_small_phase(torch, ops, dev) -> None:
    """n 2000 x 16 under churn 0.1 with refresh and compaction, every
    backend, on the CPU and on the card: the same initial state, rounding
    uniforms (one draw a step over the state's rows) and initial k-means
    rows (the indexes' default CPU generators); NAG to CARD_CPU_TOL."""
    import numpy as np

    from repro_torch import convert
    from repro_torch.core import churn, trace
    from repro_torch.core import policy_api as PA
    from repro_torch.core.costs import CostModel, calibrate_fetch_cost
    from repro_torch.index.base import IndexSpec

    cat, reqs, _ = trace.rolling_catalog(**CHURN_SMALL)
    events = trace.rolling_catalog_events(**CHURN_SMALL)
    n0 = churn.warm_size(CHURN_SMALL["n"], CHURN_SMALL["warm"])
    c_f = calibrate_fetch_cost(cat[:n0], kth=50, sample=256, device="cpu")
    spec = PA.PolicySpec("acai", {"h": 64, "k": 8})
    gen_seed = 7

    def uniforms_fn(i, n):
        return torch.rand(n, generator=torch.Generator().manual_seed(gen_seed * 100003 + i))

    state0 = None
    for backend, kw in CHURN_SMALL_SPECS.items():
        nags = {}
        for where in ("cpu", dev):
            pol = PA.build_policy(spec, cat[:n0], CostModel(c_f=c_f),
                                  index_spec=IndexSpec(backend, kw), seed=0, device=where)
            if state0 is None:
                state0 = (pol.cache.state.y.cpu().numpy(), pol.cache.state.x.cpu().numpy())
            pol.cache.state = convert.cache_state_from_numpy(*state0, 0, device=where)
            ops.reset_launches()
            res = churn.replay_with_churn(pol, cat, reqs, events, batch=8, refresh_every=1024,
                                          compact_every=512, uniforms_fn=uniforms_fn)
            nags[where] = pol.normalized_gain(res["gain"].sum(), res["requests"])
            counts = {k: v for k, v in ops.LAUNCHES.items() if v}  # the card's, last
        diff = abs(nags["cpu"] - nags[dev])
        log(f"churn n=2000 {backend} (refresh 1024, compact 512, {res['events_applied']} "
            f"events, {res['compactions']} compactions): NAG cpu={nags['cpu']} "
            f"cuda={nags[dev]} |diff|={diff} (<= {CARD_CPU_TOL}); launches on the card "
            f"{counts}")
        if not diff <= CARD_CPU_TOL:
            raise AssertionError(f"churn n=2000 {backend}: card and CPU NAG differ")
        if not np.isfinite(nags[dev]):
            raise AssertionError(f"churn n=2000 {backend}: NAG not finite")


def churn_kernel_checks(torch, ops, ref, dev) -> dict:
    """The masked kernels where the churn path takes them and the earlier
    checks did not: `l2_topk` with the sample rows of its bound all (or all
    but a few) tombstoned, and `ivf_scan_lists` / `pq_adc_lists` after an
    append that doubles the table's columns, with tombstones inside lists
    and `lens` past the last live id; then the no-reallocation guard on the
    card.  Returns the max abs errors."""
    import numpy as np

    from repro_torch.index.base import IndexSpec, build_index

    g = torch.Generator(device=dev).manual_seed(9)
    errs = {"l2_topk": 0.0, "ivf_scan_lists": 0.0, "pq_adc_lists": 0.0}
    x = torch.rand(N_FULL, D_FULL, device=dev, generator=g)
    q = torch.rand(8, D_FULL, device=dev, generator=g)
    for label, few in (("all dead", 0), ("10 live", 10)):
        valid = torch.rand(N_FULL, device=dev, generator=g) < 0.5
        valid[:ops.TOPK_SAMPLE] = False
        valid[torch.randperm(ops.TOPK_SAMPLE, device=dev, generator=g)[:few]] = True
        bound = ops.topk_l2_bound(q, torch.sum(q * q, 1), x, C_REMOTE, valid)
        if not bool(torch.isinf(bound).all()):
            raise AssertionError(f"l2_topk bound with the sample {label}: not +inf")
        gd, gi = ops.topk_l2(q, x, C_REMOTE, valid=valid)
        wd, wi = ref.l2_topk_ref(q, x, C_REMOTE + 1, valid)
        errs["l2_topk"] = max(errs["l2_topk"], compare(
            torch, f"l2_topk 8 x {N_FULL} x {D_FULL} k={C_REMOTE}, the first "
                   f"{ops.TOPK_SAMPLE} rows {label}", gd, wd, (gi, wi)))
    # some sample rows live: the bound holds over the live rows only
    valid[:ops.TOPK_SAMPLE] = torch.rand(ops.TOPK_SAMPLE, device=dev, generator=g) < 0.01
    gd, gi = ops.topk_l2(q, x, C_REMOTE, valid=valid)
    wd, wi = ref.l2_topk_ref(q, x, C_REMOTE + 1, valid)
    errs["l2_topk"] = max(errs["l2_topk"], compare(
        torch, f"l2_topk the sample rows 1% live", gd, wd, (gi, wi)))
    del x

    n0, d = 20000, D_FULL
    base = torch.rand(n0, d, device=dev, generator=g)
    for spec in (IndexSpec("ivf", {"nlist": 32, "nprobe": 8, "train_iters": 4}),
                 IndexSpec("ivfpq", {"nlist": 32, "nprobe": 8, "m": 8, "refine": 4})):
        idx = build_index(spec, base, device=dev)
        cols = idx.invlists.shape[1]
        # rows next to list 0's centroid, enough to overflow it
        near = idx.centroids[:1] + 0.01 * torch.rand(cols + 5, d, device=dev, generator=g)
        idx.add(near)
        if idx.invlists.shape[1] <= cols:
            raise AssertionError(f"churn {spec.backend}: the append did not double the columns")
        idx.remove(np.arange(0, idx.n_slots, 13))  # tombstones inside lists
        lens = ops.invlist_lengths(idx.invlists)
        if not torch.equal(lens, idx.lens):
            raise AssertionError(f"churn {spec.backend}: lens differ from the lists' lengths")
        qs = torch.cat([near[:4], torch.rand(4, d, device=dev, generator=g)])
        probe = idx.probe_lists(qs)
        what = (f"churn {spec.backend}: {cols} -> {idx.invlists.shape[1]} columns, "
                f"{idx.n_slots - idx.n} tombstones")
        if spec.backend == "ivf":
            table = ops.probed_table(idx.invlists, probe)
            gd, gi = ops.ivf_scan_lists(qs, idx.embeddings, idx.invlists, probe, C_REMOTE,
                                        valid=idx.valid, lens=idx.lens)
            wd, wi = ref.ivf_scan_ref(qs, idx.embeddings, table, C_REMOTE + 1, idx.valid)
            errs["ivf_scan_lists"] = compare(torch, "ivf_scan_lists " + what, gd, wd, (gi, wi))
        else:
            lut = idx.codec.adc_lut(qs)
            kk = IVFPQ_FULL["refine"] * C_REMOTE
            check_exact(torch, "pq_adc_lists " + what,
                        ops.pq_shortlist_lists(lut, idx.codes_lists, idx.invlists, probe, kk,
                                               valid=idx.valid, lens=idx.lens),
                        ref.pq_shortlist_ref(lut, idx.codes_lists, idx.invlists, probe, kk,
                                             idx.valid))
            if not torch.equal(idx.codes_lists, ops.codes_by_list(idx.codes, idx.invlists)):
                raise AssertionError("churn ivfpq: the list-major codes differ from "
                                     "codes_by_list after the appends")
        # no reallocation at a fixed capacity
        names = [n for n in ("embeddings", "valid", "invlists", "lens", "codes",
                             "codes_lists") if hasattr(idx, n)]
        ptrs = {n: getattr(idx, n).data_ptr() for n in names}
        for j in range(8):
            idx.add(torch.rand(1, d, device=dev, generator=g))
            idx.remove([idx.n_slots - 1])
        moved = [n for n in names if getattr(idx, n).data_ptr() != ptrs[n]]
        if moved:
            raise AssertionError(f"churn {spec.backend}: {moved} reallocated at a fixed "
                                 f"capacity")
        log(f"  churn {spec.backend}: 8 adds and removes at capacity {idx.capacity}: "
            f"{names} kept their storage")
    return errs


def churn_phase(torch, ops, ref, dev):
    """The mutable catalog at 1M x 128 on the card (CHURN_CELLS), then the
    n 2000 card-against-CPU replay and the kernel checks.  Returns the
    churn path's kernel cases (kernel_shapes.churn_cases, over this run's
    mutated indexes) and the phase's launches."""
    import numpy as np

    import kernel_shapes
    from repro_torch import convert
    from repro_torch.core import churn, trace
    from repro_torch.core import policy_api as PA
    from repro_torch.core.costs import CostModel, calibrate_fetch_cost
    from repro_torch.index.base import IndexSpec

    t_phase = time.perf_counter()
    cat, reqs, _ = trace.rolling_catalog(**CHURN_FULL)
    events = trace.rolling_catalog_events(**CHURN_FULL)
    n0 = churn.warm_size(N_FULL, CHURN_FULL["warm"])
    log(f"churn: rolling_catalog {N_FULL} x {D_FULL}, {len(events)} events, warm {n0} "
        f"({time.perf_counter() - t_phase} s)")
    c_f = calibrate_fetch_cost(cat[:n0], kth=50, sample=256, device=dev)
    spec = PA.PolicySpec("acai", {"h": H_FULL, "k": K_FULL})
    specs = {"exact": None, "flat": IndexSpec("flat"), "ivf": IndexSpec("ivf", IVF_FULL),
             "ivfpq": IndexSpec("ivfpq", IVFPQ_FULL)}
    state0, kept, nag_exact = None, {}, []
    total = {name: 0 for name in ops.LAUNCHES}
    for cell in CHURN_CELLS + [("exact", 0, 0)]:
        index, refresh_every, compact_every = cell
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pol = PA.build_policy(spec, cat[:n0], CostModel(c_f=c_f), index_spec=specs[index],
                              seed=0, device=dev)
        if state0 is None:
            state0 = pol.cache.state
        pol.cache.state = convert.cache_state_from_numpy(
            state0.y.cpu().numpy(), state0.x.cpu().numpy(), 0, seed=0, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        ops.reset_launches()
        t0 = time.perf_counter()
        res = churn.replay_with_churn(pol, cat, reqs, events, batch=8,
                                      refresh_every=refresh_every, compact_every=compact_every)
        dt = time.perf_counter() - t0
        counts = {k: v for k, v in ops.LAUNCHES.items() if v}
        for k in total:
            total[k] += ops.LAUNCHES[k]
        CHURN_SHAPES.update(ops.SHAPE_LAUNCHES)
        nag = pol.normalized_gain(res["gain"].sum(), res["requests"])
        want = CHURN_REF_NAG.get(cell)
        log(f"churn 1M {index} refresh={refresh_every} compact={compact_every}: "
            f"requests/s={res['requests'] / dt} us/request={dt / res['requests'] * 1e6} "
            f"p50_step_us={res['p50_step_s'] * 1e6} NAG={nag} reference={want} "
            f"|diff|={None if want is None else abs(nag - want)} "
            f"hit_ratio={float(res['hit'].mean())} events={res['events_applied']} "
            f"mutation_ms={res['mutation_s'] * 1e3} "
            f"mutation_device_ms={res['mutation_device_s'] * 1e3} "
            f"mutation_host_ms={res['mutation_host_s'] * 1e3} "
            f"refresh_ms={res['refresh_s'] * 1e3} refresh_stall_ms={res['refresh_stall_s'] * 1e3} "
            f"compact_ms={res['compact_s'] * 1e3} compactions={res['compactions']} "
            f"capacity={pol.cache.catalog.shape[0]} live={pol.live_count} build_s={build_s} "
            f"c_f={c_f} launches={counts} by shape={dict(ops.SHAPE_LAUNCHES)}")
        if res["events_applied"] != len(events) or pol.live_count != n0:
            raise AssertionError(f"churn 1M {cell}: {res['events_applied']} events applied, "
                                 f"{pol.live_count} live")
        if not (np.isfinite(res["gain"]).all() and 0.0 <= nag <= 1.0):
            raise AssertionError(f"churn 1M {cell}: gains not finite or NAG {nag}")
        needs = {"exact": ("pairwise_l2",), "flat": ("l2_topk",),
                 "ivf": ("ivf_scan_lists", "pairwise_l2"),
                 "ivfpq": ("pq_adc_lists", "ivf_scan", "pairwise_l2")}[index]
        for name in needs:
            if not counts.get(name):
                raise AssertionError(f"churn 1M {cell}: {name} never launched")
        if index == "exact" and cell[1:] == (0, 0):
            nag_exact.append(nag)
        if want is not None and index == "exact" and abs(nag - want) > CHURN_NAG_TOL:
            raise AssertionError(f"churn 1M {cell}: NAG {nag} against the reference's {want}")
        if cell[1:] == (0, 0) and index != "exact":
            kept[index] = pol.cache.index  # the lists after the replay's appends
        del pol
    log(f"churn 1M: the exact replay twice, NAG {nag_exact[0]} and {nag_exact[1]} "
        f"(equal: {nag_exact[0] == nag_exact[1]})")
    if nag_exact[0] != nag_exact[1]:
        raise AssertionError("churn 1M: two runs of one replay gave different NAG")
    cases = kernel_shapes.churn_cases(torch, ops, ref, torch.from_numpy(reqs).to(dev),
                                      kept["flat"], kept["ivf"], kept["ivfpq"], dev)
    log(f"churn: 1M cells {time.perf_counter() - t_phase} s")
    t0 = time.perf_counter()
    churn_small_phase(torch, ops, dev)
    log(f"churn: n=2000 card against CPU {time.perf_counter() - t0} s")
    errs = churn_kernel_checks(torch, ops, ref, dev)
    log(f"churn: kernel checks, max abs errors {errs}; phase {time.perf_counter() - t_phase} s")
    return cases, total


def flash_phase(torch, ops, ref, dev):
    """flash_attention against its plain version, f32 (the FMA kernel) and
    bf16 (the wgmma kernel), with FLASH_BF16's shapes timed in the log (the
    JSON rows come by shape, in shapes_phase)."""
    from kernel_shapes import kept_pairs
    from repro_torch.kernels import _build

    g = torch.Generator(device=dev).manual_seed(2)
    err = 0.0
    log("flash: float32 (max abs diff <= 1e-4 against the plain version)")
    ops.reset_launches()
    for (b, s, t, h, kv, d, causal, window) in FLASH_F32:
        q = torch.randn(b, s, h, d, device=dev, generator=g)
        k = torch.randn(b, t, kv, d, device=dev, generator=g)
        v = torch.randn(b, t, kv, d, device=dev, generator=g)
        for wu in (t, t - 7):
            kw = dict(causal=causal, window=window, q_offset=t - s, written_upto=wu)
            e = float((ops.flash_attention(q, k, v, **kw)
                       - ref.flash_attention_ref(q, k, v, **kw)).abs().max())
            log(f"  flash f32 B={b} S={s} T={t} H={h} KV={kv} D={d} causal={causal} "
                f"window={window} written_upto={wu}: max_abs_err={e}")
            if not e <= 1e-4:
                raise AssertionError(f"flash f32 {(b, s, t, h, kv, d)}: {e} > 1e-4")
            err = max(err, e)
    if ops.LAUNCHES["flash_attention"] != 2 * len(FLASH_F32) or ops.LAUNCHES[
            "flash_attention_wgmma"]:
        raise AssertionError(f"flash f32: launches {ops.LAUNCHES}, expected the FMA "
                             f"kernel only")

    log(f"flash: bf16, against the plain version fed the same bf16 inputs in "
        f"float32: |got - want| <= 2^-8 |want| + {F32_FLOOR} (one bf16 rounding "
        f"of the output)")

    def check_flash_bf16(name, b, s, t, h, kv, d, causal, window, q_off, wu):
        q = torch.randn(b, s, h, d, device=dev, generator=g).bfloat16()
        k = torch.randn(b, t, kv, d, device=dev, generator=g).bfloat16()
        v = torch.randn(b, t, kv, d, device=dev, generator=g).bfloat16()
        kw = dict(causal=causal, window=window, q_offset=q_off, written_upto=wu)
        ops.reset_launches()
        got = ops.flash_attention(q, k, v, **kw).float()
        if ops.LAUNCHES["flash_attention_wgmma"] != 1:
            raise AssertionError(f"flash bf16 {name}: launches {ops.LAUNCHES}, expected "
                                 f"the wgmma kernel")
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        e32 = float((ops.flash_attention(q.float(), k.float(), v.float(), **kw)
                     - want).abs().max())
        e = check_bf16(torch, f"flash bf16 {name} B={b} S={s} T={t} H={h} KV={kv} D={d} "
                              f"window={window} q_offset={q_off} written_upto={wu}",
                       got, want)
        log(f"    float32 kernel on the same inputs: max_abs_err={e32}")
        if not e32 <= 1e-4:
            raise AssertionError(f"flash f32 on {name}'s inputs: {e32} > 1e-4")
        return q, k, v, kw, e

    for case in FLASH_BF16_EDGE:
        err = max(err, check_flash_bf16(*case)[-1])
    fma = _build.load("flash_attention").flash_attention
    for (name, b, s, t, h, kv, d, causal, window, q_off, wu) in FLASH_BF16:
        q, k, v, kw, e = check_flash_bf16(name, b, s, t, h, kv, d, causal, window, q_off, wu)
        err = max(err, e)

        pairs = kept_pairs(b, s, t, causal, window, q_off, wu)
        nbytes = 2.0 * (2 * b * s * h * d + 2 * b * t * kv * d)
        bms, by = bound_ms(nbytes, 4.0 * h * d * pairs, BF16_FLOPS)
        t_k = time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw), 20)
        t_p = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw), 3, 1)
        wuu = t if wu is None else wu
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream

        def run_fma():  # the float32 FMA kernel this shape ran on before
            rc = fma(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t,
                     h, kv, d, int(causal), window, q_off, wuu, 1.0 / d ** 0.5, 1, stream)
            if rc:
                raise RuntimeError(f"flash_attention (FMA) failed with CUDA error {rc}")

        t_fma = time_ms(torch, run_fma, 5)
        qp = q_off + torch.arange(s, device=dev)[:, None]
        kp = torch.arange(t, device=dev)[None, :]
        mask = (kp < wuu).expand(s, t).clone()
        if causal:
            mask &= kp <= qp
        if window:
            mask &= kp > qp - window
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        t_l = time_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                          enable_gqa=kv != h), 5, 1)
        t_c = None
        if causal and not window and q_off == 0 and wuu == s:
            kc, vc = kt[:, :, :wuu], vt[:, :, :wuu]
            t_c = time_ms(torch, lambda: sdpa(qt, kc, vc, is_causal=True,
                                              enable_gqa=kv != h), 20, 2)
        log(f"  time flash bf16 {name}: kernel_ms={t_k} plain_ms={t_p} "
            f"fma_kernel_ms={t_fma} (csrc/flash_attention.cu) library_ms={t_l} "
            f"library_causal_ms={t_c} ({LIBRARY_CAUSAL}) bound_ms={bms} ({by}; {pairs} "
            f"kept pairs, {nbytes} bytes)")
        del q, k, v, mask, qt, kt, vt, out
    log(f"flash: max abs error {err}")


# the (d, k) of tests/test_torch_kernels.py's launch-plan cases, whose
# smem arithmetic runs there on ops.l2_topk_smem_bytes_host
TOPK_PLAN_DK = [(d, k) for d in (128, 1024, 2048, 4096, 8192) for k in (16, 51, 64)]
# l2_topk beyond the retrieval slice's width: the semantic tier's catalog at
# qwen1.5-0.5b's d_model, and yi-6b's (16 GB of float32 catalog)
TOPK_WIDE = [(64, 1_000_000, 1024, 16), (64, 1_000_000, 4096, 16)]


def topk_wide_phase(torch, ops, ref, dev) -> None:
    """l2_topk at the LM tier's widths (TOPK_WIDE): the depth is streamed,
    so a 64-query tile fits at every width.  First, the host copy of the
    kernel's smem formula must equal the library's wherever the tests plan
    with it."""
    from repro_torch.kernels import _build

    lib = _build.load("l2_topk")
    for d, k in TOPK_PLAN_DK:
        for qt in (1, 2, 4):
            host, card = ops.l2_topk_smem_bytes_host(qt, d, k), lib.l2_topk_smem_bytes(qt, d, k)
            if host != card:
                raise AssertionError(f"l2_topk smem bytes at qt={qt} d={d} k={k}: host "
                                     f"copy {host}, l2_topk.cu {card}")
    log(f"  l2_topk smem formula: host copy equals l2_topk.cu at "
        f"{3 * len(TOPK_PLAN_DK)} (qt, d, k)")
    g = torch.Generator(device=dev).manual_seed(3)
    for (nq, n, d, k) in TOPK_WIDE:
        x = torch.randn(n, d, device=dev, generator=g)
        q = torch.randn(nq, d, device=dev, generator=g)
        qt = ops.topk_l2_query_tile(nq, d, k, lib.l2_topk_smem_bytes)
        gd, gi = ops.topk_l2(q, x, k)
        wd, wi = ref.l2_topk_ref(q, x, k + 1)
        compare(torch, f"l2_topk {nq} x {n} x {d} k={k} (query tile {16 * qt})",
                gd, wd, (gi, wi))
        del gd, gi, wd, wi
        t_k = time_ms(torch, lambda: ops.topk_l2(q, x, k), 5, 1)
        t_l = time_ms(torch, lambda: torch.topk(torch.cdist(q, x), k, largest=False), 3, 1)
        nbytes, flops = 4.0 * (n * d + nq * d) + 8.0 * nq * k, 2.0 * nq * n * d
        bms, by = bound_ms(nbytes, flops, TF32_FLOPS)
        log(f"  time l2_topk [Q={nq} N={n} D={d} k={k}]: kernel_ms={t_k} "
            f"library_ms={t_l} bound_ms={bms} ({by}; at the float32 FMA rate "
            f"{bound_ms(nbytes, flops)[0]})")
        del x, q
        torch.cuda.empty_cache()


def lm_parity_phase(torch, ops, dev):
    """qwen1.5-0.5b SMOKE, float32, flash path forced: card against CPU."""
    import numpy as np

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core.costs import calibrate_fetch_cost
    from repro_torch.launch.serve import semantic_traffic
    from repro_torch.models import init_params
    from repro_torch.serve import SemanticCachedLM, ServeEngine, generate

    cfg = dataclasses.replace(get_config(LM_ARCH, smoke=True), dtype="float32",
                              flash_threshold=32, flash_chunk=16)
    models = {"cpu": init_params(cfg, seed=0, device="cpu")}
    models[dev] = copy.deepcopy(models["cpu"]).to(dev)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))
    eng_prompts = [torch.from_numpy(rng.integers(0, cfg.vocab, n))
                   for n in rng.integers(20, 41, 7)]
    # the launcher's traffic: a catalog of 2000 earlier prompts'
    # embeddings, 48 requests repeating them with Zipf(0.9) popularity
    n = 2000
    cat, reqs, _ = semantic_traffic(models["cpu"], cfg, n, 24, 48, rng, "cpu")
    singles, batches = reqs[:24], [reqs[i:i + 8] for i in range(24, 48, 8)]
    c_f = calibrate_fetch_cost(cat, kth=50, device="cpu")
    uniforms = torch.rand(len(singles) + len(batches), n,
                          generator=torch.Generator().manual_seed(7))
    state0 = None
    out = {}
    for where in ("cpu", dev):
        model = models[where]
        ops.reset_launches()
        toks = generate(model, cfg, prompt.to(where), steps=8, s_max=64).cpu()
        engine = ServeEngine(model, cfg, batch=3, s_max=64)
        for i, p in enumerate(eng_prompts):
            engine.submit(i, p.to(where), max_tokens=6)
        while engine.step():
            pass
        lm = SemanticCachedLM(
            model, cfg, cat, list(range(n)),
            lambda p, m=model: generate(m, cfg, p.to(where)[None], steps=4, s_max=64),
            h=64, k=4, c_f=c_f)
        if state0 is None:
            state0 = lm.cache.state
        lm.cache.state = convert.cache_state_from_numpy(
            state0.y.cpu().numpy(), state0.x.cpu().numpy(), state0.t, device=where)
        served = []
        for i, p in enumerate(singles):
            served.append(int(lm.query(p, uniforms[i].to(where)).served_local))
        for j, ps in enumerate(batches):
            m = lm.query_batch(ps, uniforms[len(singles) + j].to(where))
            served.extend(m.served_local.tolist())
        if where != "cpu":
            torch.cuda.synchronize()
        out[where] = (toks, dict(engine.done), lm.nag, served, lm.stats.generated,
                      dict(ops.LAUNCHES))
    (t0, d0, nag0, s0, g0, _), (t1, d1, nag1, s1, g1, counts) = out["cpu"], out[dev]
    same_served = sum(a == b for a, b in zip(s0, s1)) / len(s0)
    log(f"lm parity (qwen1.5-0.5b SMOKE, float32, flash_threshold 32): generate "
        f"tokens equal={torch.equal(t0, t1)}; ServeEngine done equal={d0 == d1} "
        f"({len(d0)} requests); SemanticCachedLM NAG cpu={nag0} cuda={nag1} "
        f"|diff|={abs(nag0 - nag1)}, served_local equal for {same_served} of "
        f"requests, generations {g0} / {g1}; launches on the card: {counts}")
    if not torch.equal(t0, t1):
        raise AssertionError("lm parity: generate tokens differ between card and CPU")
    if d0 != d1:
        raise AssertionError("lm parity: ServeEngine outputs differ")
    if not abs(nag0 - nag1) < 1e-3:
        raise AssertionError("lm parity: SemanticCachedLM NAG differs by 1e-3 or more")
    if g0 != g1 or g0 == 0:
        raise AssertionError(f"lm parity: generations {g0} on the CPU, {g1} on the card")
    if counts["flash_attention"] == 0:
        raise AssertionError("lm parity: flash_attention never launched on the card")


def lm_slice_phase(torch, ops, card: str):
    """qwen1.5-0.5b at full width through the launcher; returns the summed
    launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lm_serve

    n_layers = get_config(LM_ARCH).n_layers
    total = {name: 0 for name in ops.LAUNCHES}
    for name, argv in LM_RUNS.items():
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fig = lm_serve.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        eng, sem = fig["engine"], fig.get("semantic")
        prefills = eng["prefills"] + (sem["generations"] if sem else 0)
        log(f"lm slice {name} [{card}]: {dt} s; launches={counts}; prefills={prefills}")
        log(f"  engine: prefill_ms_per_request={eng['prefill_ms_per_request']} "
            f"decode_tokens_per_s={eng['decode_tokens_per_s']} "
            f"requests={eng['requests']} tokens={eng['tokens']} "
            f"prompt_tokens={eng['prompt_tokens']} decode_steps={eng['decode_steps']} "
            f"s_max={eng['s_max']} logits_finite={eng['logits_finite']}")
        if sem:
            log(f"  semantic: index={sem['index']} "
                f"us_per_request={sem['us_per_request']} "
                f"us_per_request_without_generation="
                f"{sem['us_per_request_without_generation']} NAG={sem['nag']} "
                f"generations={sem['generations']} generate_share="
                f"{sem['generate_share']} served_local={sem['served_local']}"
                f"/{sem['objects']} requests={sem['requests']} distinct_objects="
                f"{sem['distinct_objects']} c_f={sem['c_f']} "
                f"traffic_s={sem['traffic_s']} build_s={sem['build_s']}")
            if not 0.0 <= sem["nag"] <= 1.0:
                raise AssertionError(f"lm slice {name}: NAG {sem['nag']} outside [0, 1]")
            for k in LM_NEEDS:
                if counts[k] == 0:
                    raise AssertionError(f"lm slice {name}: {k} never launched")
        if not eng["logits_finite"]:
            raise AssertionError(f"lm slice {name}: non-finite prefill logits")
        if counts["flash_attention_wgmma"] != n_layers * prefills or counts["flash_attention"]:
            raise AssertionError(
                f"lm slice {name}: flash_attention_wgmma launched "
                f"{counts['flash_attention_wgmma']} times and the FMA flash kernel "
                f"{counts['flash_attention']} for {prefills} prefills of {n_layers} layers")
        for k in total:
            total[k] += counts[k]
        MAIN_SHAPES.update(ops.SHAPE_LAUNCHES)
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
    sys.path.insert(0, str(ROOT / "scripts"))  # kernel_shapes: the timed cases
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import trace
    from repro_torch.index.ivf import IVFFlatIndex
    from repro_torch.index.pq import IVFPQIndex
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
                                   if any(w in line for w in ("registers", "spill",
                                                              "arning"))))

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

    t0 = time.perf_counter()
    pq_index = IVFPQIndex(catalog, device=dev, **IVFPQ_FULL)
    torch.cuda.synchronize()
    log(f"data: IVF-PQ index for the kernel phase, longest list "
        f"{pq_index.invlists.shape[1]}, {pq_index.compressed_bytes()} compressed "
        f"bytes ({time.perf_counter() - t0} s)")

    kernel_phase(torch, ops, ref, catalog, reqs, ivf_index, pq_index, dev)
    parity_phase(torch, ops, dev)
    launches = slice_phase(torch, ops, cat_np, reqs_np, dev)
    pol_launches = policies_phase(torch, ops, cat_np, reqs_np, dev)
    del cat_np, reqs_np
    torch.cuda.empty_cache()
    churn_cases, churn_launches = churn_phase(torch, ops, ref, dev)

    flash_phase(torch, ops, ref, dev)
    topk_wide_phase(torch, ops, ref, dev)
    torch.cuda.empty_cache()
    lm_parity_phase(torch, ops, dev)
    lm_launches = lm_slice_phase(torch, ops, card)
    # last: once torch.profiler has traced the card, every later launch in
    # this process pays its callbacks, so no host-clock figure comes after
    rows = shapes_phase(torch, ops, ref, catalog, reqs, ivf_index, pq_index, dev,
                        churn_cases)
    del ivf_index, pq_index, catalog, reqs, churn_cases
    for name in sorted({k for k, _ in MAIN_SHAPES}):
        total = launches[name] + pol_launches[name] + lm_launches[name]
        log(f"main path {name}: {total} launches; by shape: "
            + ", ".join(f"{dims} x {n}" for (k, dims), n in sorted(MAIN_SHAPES.items())
                        if k == name))
    for name in sorted({k for k, _ in CHURN_SHAPES}):
        log(f"churn path {name}: {churn_launches[name]} launches; by shape: "
            + ", ".join(f"{dims} x {n}" for (k, dims), n in sorted(CHURN_SHAPES.items())
                        if k == name))
    for row in rows:
        row["launches"] = shape_launches(CHURN_SHAPES if row.pop("churn") else MAIN_SHAPES,
                                         *row.pop("key"))
        if row.pop("main") and row["launches"] == 0:
            raise AssertionError(f"{row['name']} [{row['shape']}] was never launched "
                                 f"on the main path")
    # every TPU kernel through at least one of its designs (pq_adc.py:60's
    # per-query kernel is off the main path; its list-major one is on it)
    for replaces in {meta[1] for meta in KERNEL_META.values()}:
        if not sum(r["launches"] for r in rows if r["replaces"] == replaces):
            raise AssertionError(f"no kernel replacing {replaces} was launched on the main "
                                 f"path")
    line = [r for n in KERNEL_META for r in rows if r["name"] == n]
    log(f"total: {time.perf_counter() - t_start} s")
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
