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
6b. serving — the serving tier at 1M x 128, h 400, k 10, B 8, 2048
             requests: (a) AÇAI with the answer cache (capacity 4096) and in
             pass-through (capacity 0) over flat, IVF and IVF-PQ on
             benchmarks/answer_cache_bench.py's Zipf 1.1 trace, and over
             flat and IVF on its flash_crowd trace: gains, y, x and served
             ids equal bit for bit, no index kernel launched on an all-hit
             batch (the cached-row `pairwise_l2` scan only), a memoized
             batch >= 5x faster than a flat scan of it (30 repetitions;
             IVF's ratio logged); the IVF
             index unloaded (bytes freed read from the allocator, a scan
             of it refusing the host), reloaded unchanged, and the engine
             with idle_unload_ms against pass-through; its rolling catalog
             (churn 0.05) over flat: no removed id served, invalidations by
             reason; (b) AÇAI over flat through the resilient tier on the
             slice's sift_like: fault free equal to the plain replay bit for
             bit, error 0.2 and an outage over a tenth of the trace, the
             schedule's counters equal to a CPU session's; (c) the online
             engine (poisson and flash_crowd at 0.5 / 0.8 / 1.2 of capacity,
             closed loop) under the reference's service model and one fitted
             to the card's B 8 / B 64 steps, and the fixed-window engine
             equal to `AcaiPolicy.replay` bit for bit; then the n 2000 x 16
             settings of BENCH_serving.json, BENCH_resilience.json and
             BENCH_answer_cache.json for every registered policy on the card
             and through the CPU port (same uniforms): every virtual-clock
             field equal, NAG within 1e-3, and against the files AÇAI within
             0.03 and the baselines within 1e-3.  Its launches count by
             shape with the main path's (the rolling run's with the churn
             path's); `--only serving` runs the build and this phase alone
             and prints no result;
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
    """The 1M x 128 serving runs (launches counted by shape into
    MAIN_SHAPES)."""
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
            MAIN_SHAPES.update(ops.SHAPE_LAUNCHES)
            log(f"slice {spec.backend} B={b}: requests/s={T_FULL / dt} "
                f"us/request={dt / T_FULL * 1e6} NAG={nag} "
                f"served_local/request={float(torch.cat(served).float().mean())} "
                f"occupancy={float(occ[-1])} build_s={build_s} serve_s={dt} "
                f"launches={counts}")


def policies_phase(torch, ops, catalog_np, reqs_np, dev):
    """The policy registry, the baselines and the experiments harness on the
    card: BENCH_experiments.json's grid, the sift_like AÇAI row card
    against CPU, then the six policies at 1M x 128 (launches counted by
    shape into MAIN_SHAPES)."""
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
    mutated indexes); launches are counted by shape into CHURN_SHAPES."""
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
    return cases


# ---------------------------------------------------------------------------
# the serving phase (the answer cache, the resilient remote tier, the online
# engine)
# ---------------------------------------------------------------------------

# benchmarks/answer_cache_bench.py's Zipf trace (seed 17, Zipf 1.1, jitter
# 0: repeats are exact catalog rows) and rolling catalog (churn 0.05, warm
# 0.5) at the slice's 1M x 128; its capacity, hot-path repetitions and
# speedup floor
SERVE_ZIPF = {"n": N_FULL, "d": D_FULL, "t": T_FULL, "zipf_a": 1.1, "jitter": 0.0,
              "seed": 17}
SERVE_ROLLING = {"n": N_FULL, "d": D_FULL, "t": T_FULL, "churn_rate": 0.05, "warm": 0.5,
                 "seed": 17}
# its flash_crowd trace (seed 7: four windows of 8 % of the trace send 80 %
# of the requests to 20 objects): at 1M x 128 the Zipf trace's barycentric
# popularity is nearly flat, so the repeats, and the all-hit batches, are
# the crowds'
SERVE_CROWD = {"n": N_FULL, "d": D_FULL, "t": T_FULL, "seed": 7}
SERVE_CAP, SERVE_HOT_REPS, SERVE_MIN_SPEEDUP = 4096, 30, 5.0
SERVE_BATCH = 8
# the virtual-clock idle threshold of the unload run, and its offered load
SERVE_IDLE_MS, SERVE_IDLE_LOAD = 10.0, 0.2
# the online engine's grid: loads as fractions of capacity_rps(8), the
# batch window, SLO and queue cap of benchmarks/serving_bench.py
SERVE_LOADS, SERVE_WINDOW_MS, SERVE_SLO_MS, SERVE_QUEUE_CAP = (0.5, 0.8, 1.2), 5.0, 25.0, 64
# the resilience cells at 1M: error rate 0.2 with the default 2 retries
# and a 250 ms deadline; an outage over the middle tenth of the trace
SERVE_FAULTS = {"fault_free": {},
                "error 0.2": {"error_rate": 0.2},
                "outage tenth": {"outages": ((int(0.45 * T_FULL), int(0.55 * T_FULL)),)}}
# the parity size: the reference's bench files (n 2000 x 16, 2048
# requests, h 64, k 8, B 8, their c_f)
BENCH_SERVING = ROOT / "BENCH_serving.json"
BENCH_RESILIENCE = ROOT / "BENCH_resilience.json"
BENCH_ANSWER = ROOT / "BENCH_answer_cache.json"
# launches by (kernel, shape) in the serving phase (the rolling-catalog
# run's are the churn path's shapes)
SERVING_SHAPES: Counter = Counter()
SERVING_CHURN_SHAPES: Counter = Counter()


class InjectedUniforms:
    """An AÇAI policy whose every step takes its rounding uniforms from a
    CPU generator seeded by the step's index (`step_uniforms`): the same
    numbers on the card and on the CPU, whichever driver calls the step."""

    def __init__(self, pol, seed: int):
        self.pol, self.seed, self.steps = pol, seed, 0

    def __getattr__(self, name):
        return getattr(self.pol, name)

    def serve_update_batch(self, rs, ts=None):
        u = step_uniforms(self.seed, self.steps, self.pol.cache.state.y.shape[0])
        self.steps += 1
        return self.pol.serve_update_batch(rs, ts, u=u.to(self.pol.cache.device))


def step_uniforms(seed: int, i: int, n: int):
    import torch

    return torch.rand(n, generator=torch.Generator().manual_seed(seed * 100003 + i))


def tap_served(pol, sink: list, clock: list | None = None) -> None:
    """Record every index answer's ids (with the step they came in, when
    `clock` is given) at the policy's index `query`."""
    idx = pol.cache.index
    orig = idx.query

    def query(rs, k):
        d, ids = orig(rs, k)
        sink.append(ids if clock is None else (clock[0], ids))
        return d, ids

    idx.query = query


def frozen_spec(torch, name: str, cat, dev):
    """The IndexSpec of `name` at the slice's settings that loads one trained
    index's structures: every policy built from it holds the same lists
    and codebooks (k-means on the card sums its clusters with atomics, so
    two trainings may differ in the last digit)."""
    from repro_torch.index.base import IndexSpec, build_index

    if name == "flat":
        return IndexSpec("flat")
    params = dict(IVF_FULL if name == "ivf" else IVFPQ_FULL)
    idx = build_index(IndexSpec(name, params), cat, device=dev)
    params.update(centroids=idx.centroids.cpu().numpy(), invlists=idx.invlists.cpu().numpy())
    if name == "ivfpq":
        params.update(codebooks=idx.codec.codebooks.cpu().numpy(),
                      codes=idx.codes.cpu().numpy())
    del idx
    return IndexSpec(name, params)


def serve_steps(torch, ops, pol, reqs_np, b: int = SERVE_BATCH) -> dict:
    """`pol` over the trace in host batches of b; per step the gains, the
    answer tier's hit mask and the launches of the all-hit steps; the
    median step (the card synchronised after each)."""
    import numpy as np

    gains, hits, walls = [], [], []
    allhit, n_allhit = Counter(), 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, reqs_np.shape[0] - b + 1, b):
        before = Counter(ops.LAUNCHES)
        t_step = time.perf_counter()
        m = pol.serve_update_batch(reqs_np[s:s + b])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t_step)
        h = m.answer_hits if isinstance(m.answer_hits, torch.Tensor) else torch.zeros(b)
        if int(h.sum()) == b:
            allhit.update(Counter(ops.LAUNCHES) - before)
            n_allhit += 1
        gains.append(m.gain_int)
        hits.append(h)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    g = torch.cat(gains)
    return {"gain": g, "hits": torch.cat(hits), "seconds": dt, "allhit": allhit,
            "n_allhit": n_allhit, "requests": g.shape[0],
            "p50_step_us": float(np.median(walls)) * 1e6}


def serving_answer_cache(torch, ops, dev, traces, state0) -> None:
    """(a) AÇAI with the answer cache on and in pass-through, per trace of
    `traces` ({name: (catalog, requests, c_f, backends)}): gains, y, x and
    served ids equal bit for bit; the all-hit batches launch no index
    kernel.  Then the hot-path latency and the idle unload, on the
    flash-crowd trace's flat and IVF policies."""
    from repro_torch.core import policy
    from repro_torch.core import policy_api as PA
    from repro_torch.core.costs import CostModel
    from repro_torch.index.base import build_index
    from repro_torch.serve.answer_cache import AnswerCacheSpec

    spec = PA.PolicySpec("acai", {"h": H_FULL, "k": K_FULL, "batch": SERVE_BATCH})
    kept, frozen = {}, {}
    # a warm-up replay (the phase's first launches of the step's kernels),
    # so the first arm timed does not pay it
    cat, reqs, c_f, _ = traces["zipf"]
    warm = PA.build_policy(spec, cat, CostModel(c_f=c_f), index_spec=frozen_spec(
        torch, "flat", cat, dev), seed=0, answer_cache=AnswerCacheSpec(capacity=0), device=dev)
    serve_steps(torch, ops, warm, reqs[:32 * SERVE_BATCH])
    del warm
    for trace_name, (cat, reqs, c_f, backends) in traces.items():
        for name in backends:
            t0 = time.perf_counter()
            ispec = frozen_spec(torch, name, cat, dev)
            index = build_index(ispec, cat, device=dev)
            for s in range(0, 16 * SERVE_BATCH, SERVE_BATCH):  # the index's warm-up
                index.query(torch.from_numpy(reqs[s:s + SERVE_BATCH]).to(dev), C_REMOTE)
            del index
            log(f"serving (a) {trace_name} {name}: structures trained once for both arms "
                f"({time.perf_counter() - t0} s)")
            arms = {}
            for cap in (SERVE_CAP, 0):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pol = PA.build_policy(spec, cat, CostModel(c_f=c_f), index_spec=ispec,
                                      seed=0, answer_cache=AnswerCacheSpec(capacity=cap),
                                      device=dev)
                pol.cache.state = policy.copy_state(state0, seed=0)
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t0
                served = []
                tap_served(pol, served)
                ops.reset_launches()
                r = serve_steps(torch, ops, pol, reqs)
                SERVING_SHAPES.update(ops.SHAPE_LAUNCHES)
                st = pol.answer_cache.stats()
                nag = pol.normalized_gain(float(r["gain"].sum()), r["requests"])
                log(f"serving (a) {trace_name} {name} cache="
                    f"{'on' if cap else 'pass-through'}: NAG={nag} "
                    f"answer_hit_rate={st['hit_rate']} scans={st['scans']} "
                    f"scans_skipped={st['scans_skipped']} "
                    f"key_readbacks={st['key_readbacks']} "
                    f"us/request={r['seconds'] / r['requests'] * 1e6} "
                    f"p50_step_us={r['p50_step_us']} build_s={build_s} "
                    f"all-hit steps={r['n_allhit']} launches on them={dict(r['allhit'])} "
                    f"launches={ {k: v for k, v in ops.LAUNCHES.items() if v} }")
                arms[cap] = (r, pol, torch.cat([i.reshape(-1) for i in served]))
            (on, pol_on, ids_on), (off, pol_off, ids_off) = arms[SERVE_CAP], arms[0]
            parts = {"gain": torch.equal(on["gain"], off["gain"]),
                     "y": torch.equal(pol_on.cache.state.y, pol_off.cache.state.y),
                     "x": torch.equal(pol_on.cache.state.x, pol_off.cache.state.x),
                     "served ids": torch.equal(ids_on, ids_off)}
            same = all(parts.values())
            log(f"serving (a) {trace_name} {name}: cache-on equals pass-through bit for "
                f"bit {parts}; max |gain diff| "
                f"{float((on['gain'] - off['gain']).abs().max())}; us/request on "
                f"{on['seconds'] / on['requests'] * 1e6} off "
                f"{off['seconds'] / off['requests'] * 1e6}; p50 step us on "
                f"{on['p50_step_us']} off {off['p50_step_us']}")
            if not same:
                raise AssertionError(f"serving (a) {trace_name} {name}: the answer cache "
                                     f"changed what is served")
            # an all-hit batch launches no index kernel: its one launch is
            # the cached-row scan (`pairwise_l2` at (B, local cap)), which
            # reads x and so is never memoized
            index_launches = {k: v for k, v in on["allhit"].items() if k != "pairwise_l2"}
            if index_launches or on["allhit"]["pairwise_l2"] != on["n_allhit"]:
                raise AssertionError(f"serving (a) {trace_name} {name}: all-hit batches "
                                     f"launched {dict(on['allhit'])} over "
                                     f"{on['n_allhit']} batches")
            if pol_on.answer_cache.key_readbacks:
                raise AssertionError(f"serving (a) {trace_name} {name}: keys read back "
                                     f"from the card")
            if trace_name == "flash_crowd":
                if on["n_allhit"] == 0:
                    raise AssertionError(f"serving (a) {trace_name} {name}: no batch was "
                                         f"served all from the store")
                kept[name], frozen[name] = pol_on, ispec
            del arms, pol_off, pol
    cat, reqs = traces["flash_crowd"][:2]
    c_f = traces["flash_crowd"][2]
    serving_hot_path(torch, dev, kept, reqs)
    serving_unload(torch, ops, dev, kept["ivf"], cat, reqs, c_f, state0, frozen["ivf"])
    del kept
    torch.cuda.empty_cache()


def serving_hot_path(torch, dev, pols, reqs) -> None:
    """answer_cache_bench.py's hot latency: a memoized all-hit batch (the
    trace's most repeated rows) against a scan of the same batch, 30 times
    each, in turns, the card synchronised around each and Python's garbage
    collector held off: over the flat index (the bench's cell) the p50
    speedup must reach its min_speedup 5; over IVF it is logged."""
    import gc

    import numpy as np

    for name in ("flat", "ivf"):
        ci = pols[name].answer_cache
        k = pols[name].cache.cfg.c_remote
        uniq, counts = np.unique(reqs, axis=0, return_counts=True)
        hot = np.ascontiguousarray(uniq[np.argsort(-counts)[:SERVE_BATCH]])
        hot_dev = torch.from_numpy(hot).to(dev)
        ci.stage(hot)
        ci.query(hot_dev, k)  # stored
        walls = {"hit": [], "scan": []}
        skipped = ci.cache.scans_skipped
        gc.collect()
        gc.disable()
        for _ in range(SERVE_HOT_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ci.stage(hot)
            ci.query(hot_dev, k)
            torch.cuda.synchronize()
            walls["hit"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            ci.inner.query(hot_dev, k)
            torch.cuda.synchronize()
            walls["scan"].append(time.perf_counter() - t0)
        gc.enable()
        if ci.cache.scans_skipped - skipped != SERVE_HOT_REPS:
            raise AssertionError(f"serving hot path {name}: batches not served from the "
                                 f"store")
        p_hit = float(np.percentile(walls["hit"], 50))
        p_scan = float(np.percentile(walls["scan"], 50))
        log(f"serving (a) hot path {name}: memoized all-hit batch p50 {p_hit * 1e6} us, "
            f"scan of the same batch p50 {p_scan * 1e6} us, speedup {p_scan / p_hit}"
            f"{f' (>= {SERVE_MIN_SPEEDUP})' if name == 'flat' else ''}; "
            f"{SERVE_HOT_REPS} repetitions each")
        if name == "flat" and p_scan / p_hit < SERVE_MIN_SPEEDUP:
            raise AssertionError(f"serving hot path {name}: speedup below "
                                 f"{SERVE_MIN_SPEEDUP}")


def serving_unload(torch, ops, dev, pol, cat, reqs, c_f, state0, ivf_spec) -> None:
    """The idle unload at 1M on the IVF index: unload frees the lists and
    centroids on the card (read from the allocator), hits serve while
    unloaded, an unloaded scan refuses the host, a miss reloads them
    unchanged; then the online engine with idle_unload_ms against
    pass-through, gains bit for bit."""
    import numpy as np

    from repro_torch.core import policy
    from repro_torch.core import policy_api as PA
    from repro_torch.core.costs import CostModel
    from repro_torch.serve.answer_cache import AnswerCacheSpec
    from repro_torch.serve.arrivals import ArrivalSpec
    from repro_torch.serve.queue import BatchFormerConfig, OnlineServingEngine, ServiceModel

    ci = pol.answer_cache
    k = pol.cache.cfg.c_remote
    cold = torch.from_numpy(cat[-SERVE_BATCH:]).to(dev)   # rows no request asked for
    d0, i0 = ci.inner.query(cold, k)
    torch.cuda.synchronize()
    freed = ci.unload()
    moved = sorted(f"{n}.{s}" if s else n for n, s, _ in ci._offloaded)
    log(f"serving (a) unload ivf: moved {moved} to the host, {ci.last_unload_nbytes} "
        f"tensor bytes, {freed} bytes freed on the card (torch.cuda.memory_allocated)")
    if ci.loaded or freed <= 0 or ci.inner.invlists.device.type != "cpu":
        raise AssertionError("serving unload: the IVF structures did not leave the card")
    try:
        ci.inner.query(cold, k)
    except ValueError as e:
        log(f"serving (a) unload ivf: a scan of the unloaded index refuses the host: {e}")
    else:
        raise AssertionError("serving unload: an unloaded index scanned on the host")
    hot = np.ascontiguousarray(reqs[:SERVE_BATCH])
    ci.stage(hot)
    ci.query(torch.from_numpy(hot).to(dev), k)  # served from the store: stays unloaded
    if ci.loaded:
        raise AssertionError("serving unload: a hit reloaded the index")
    ci.query(cold + 1e-3, k)    # a miss: reload, scan
    d1, i1 = ci.inner.query(cold, k)
    same = torch.equal(d0, d1) and torch.equal(i0, i1)
    log(f"serving (a) unload ivf: reloaded to {ci.inner.invlists.device} "
        f"(unloads {ci.unloads}, reloads {ci.reloads}); answers after the reload equal "
        f"before it bit for bit: {same}")
    if not (same and ci.loaded and ci.reloads == 1):
        raise AssertionError("serving unload: the reload changed the answers")

    service = ServiceModel()
    arrival = ArrivalSpec(kind="poisson", rate_rps=SERVE_IDLE_LOAD * service.capacity_rps(
        SERVE_BATCH), seed=11)
    runs = {}
    for cap in (SERVE_CAP, 0):
        p = PA.build_policy(PA.PolicySpec("acai", {"h": H_FULL, "k": K_FULL,
                                                   "batch": SERVE_BATCH}),
                            cat, CostModel(c_f=c_f), index_spec=ivf_spec,
                            seed=0, device=dev, answer_cache=AnswerCacheSpec(
                                capacity=cap, idle_unload_ms=SERVE_IDLE_MS if cap else None))
        p.cache.state = policy.copy_state(state0, seed=0)
        ops.reset_launches()
        # fixed batches of 8: a memoized answer equals a recomputed one bit
        # for bit at one batch shape (a scan of another B may round its
        # distances otherwise), so the dynamic window is not used here
        res = OnlineServingEngine(p, former=BatchFormerConfig(SERVE_BATCH, None),
                                  service=service).run(reqs, arrival)
        SERVING_SHAPES.update(ops.SHAPE_LAUNCHES)
        runs[cap] = (res, p.answer_cache.stats())
    (on, st), (off, _) = runs[SERVE_CAP], runs[0]
    log(f"serving (a) engine ivf idle_unload_ms={SERVE_IDLE_MS} at {SERVE_IDLE_LOAD} of "
        f"capacity: unloads={st['unloads']} reloads={st['reloads']} "
        f"freed on the last unload {st['last_unload_allocator_bytes']} bytes (allocator), "
        f"answer_hit_rate={on['answer_hit_rate']} p50_user_ms={on['p50_user_ms']} "
        f"p50_hit_ms={on['p50_hit_ms']} p50_miss_ms={on['p50_miss_ms']}; gains equal "
        f"pass-through's: {bool((on['gain'] == off['gain']).all())}")
    if st["unloads"] < 1 or st["reloads"] < 1 or st["last_unload_allocator_bytes"] <= 0:
        raise AssertionError("serving unload: the engine never unloaded and reloaded")
    if not (on["gain"] == off["gain"]).all():
        raise AssertionError("serving unload: idle unloads changed the gains")


def serving_churn(torch, ops, dev) -> None:
    """The rolling catalog at 1M x 128, churn 0.05, AÇAI over flat with the
    answer cache and in pass-through: equal gains, no removed id served
    after its removal, the invalidations by reason."""
    import numpy as np

    from repro_torch.core import churn, trace
    from repro_torch.core import policy_api as PA
    from repro_torch.core.costs import CostModel, calibrate_fetch_cost
    from repro_torch.index.base import IndexSpec
    from repro_torch.serve.answer_cache import AnswerCacheSpec

    t0 = time.perf_counter()
    cat, reqs, _ = trace.rolling_catalog(**SERVE_ROLLING)
    events = trace.rolling_catalog_events(**SERVE_ROLLING)
    n0 = churn.warm_size(N_FULL, SERVE_ROLLING["warm"])
    c_f = calibrate_fetch_cost(cat[:n0], kth=50, device=dev)
    log(f"serving (a) rolling_catalog {N_FULL} x {D_FULL} churn "
        f"{SERVE_ROLLING['churn_rate']}: {len(events)} events, c_f {c_f} "
        f"({time.perf_counter() - t0} s)")
    arms = {}
    state0 = None
    for cap in (SERVE_CAP, 0):
        pol = PA.build_policy(PA.PolicySpec("acai", {"h": H_FULL, "k": K_FULL}),
                              cat[:n0], CostModel(c_f=c_f), index_spec=IndexSpec("flat"),
                              seed=0, device=dev, answer_cache=AnswerCacheSpec(capacity=cap))
        from repro_torch.core import policy

        if state0 is None:
            state0 = pol.cache.state
        pol.cache.state = policy.copy_state(state0, seed=0)
        step, served, removed = [0], [], {}
        tap_served(pol, served, step)
        orig_remove, orig_serve = pol.remove_objects, pol.serve_update_batch

        def remove(ids, orig_remove=orig_remove, step=step, removed=removed):
            for i in np.atleast_1d(np.asarray(ids)).tolist():
                removed[int(i)] = step[0]
            orig_remove(ids)

        def serve(rs, ts=None, orig_serve=orig_serve, step=step, **kw):
            m = orig_serve(rs, ts, **kw)
            step[0] += 1
            return m

        pol.remove_objects, pol.serve_update_batch = remove, serve
        ops.reset_launches()
        t0 = time.perf_counter()
        res = churn.replay_with_churn(pol, cat, reqs, events, batch=SERVE_BATCH)
        dt = time.perf_counter() - t0
        SERVING_CHURN_SHAPES.update(ops.SHAPE_LAUNCHES)
        st = pol.answer_cache.stats()
        # an id served at a step at or after its removal (no compaction
        # runs, so ids stay slab ids)
        late = 0
        for s, ids in served:
            for i in torch.unique(ids).tolist():
                if i in removed and removed[i] <= s:
                    late += 1
        nag = pol.normalized_gain(res["gain"].sum(), res["requests"])
        log(f"serving (a) rolling flat cache={'on' if cap else 'pass-through'}: NAG={nag} "
            f"events={res['events_applied']} answer_hit_rate={st['hit_rate']} "
            f"invalidations={st['invalidations']} (remove={st['inv_remove']} "
            f"add={st['inv_add']} refresh={st['inv_refresh']}) scans_skipped="
            f"{st['scans_skipped']} us/request={dt / res['requests'] * 1e6} "
            f"removed ids served after their removal: {late}")
        if late:
            raise AssertionError("serving churn: a removed id was served")
        arms[cap] = (res["gain"], st)
    (g_on, st_on), (g_off, _) = arms[SERVE_CAP], arms[0]
    if not np.array_equal(g_on, g_off):
        raise AssertionError("serving churn: the answer cache changed the gains")
    if st_on["inv_remove"] == 0 or st_on["hits"] == 0:
        raise AssertionError("serving churn: no hit or no invalidation under churn")
    log("serving (a) rolling flat: cache-on gains equal pass-through's bit for bit")


def serving_resilience(torch, ops, dev, cat, reqs, c_f, state0) -> None:
    """(b) AÇAI over flat through AcaiResilience at 1M: fault free equal to
    the plain replay bit for bit; error 0.2 and an outage over a tenth of
    the trace; the schedule's counters against a CPU session."""
    from repro_torch.core import policy
    from repro_torch.core import policy_api as PA
    from repro_torch.core.costs import CostModel
    from repro_torch.index.base import IndexSpec
    from repro_torch.serve.remote import FaultSpec, FaultyRemote
    from repro_torch.serve.resilience import (RemoteSession, ResilienceConfig,
                                              ResilientPolicy, RetryConfig,
                                              replay_resilient)

    spec = PA.PolicySpec("acai", {"h": H_FULL, "k": K_FULL, "batch": SERVE_BATCH})

    def build():
        p = PA.build_policy(spec, cat, CostModel(c_f=c_f), index_spec=IndexSpec("flat"),
                            seed=0, device=dev)
        p.cache.state = policy.copy_state(state0, seed=0)
        return p

    plain = build()
    ops.reset_launches()
    ref = plain.replay(reqs)
    SERVING_SHAPES.update(ops.SHAPE_LAUNCHES)
    rcfg = ResilienceConfig(deadline_ms=250.0, retry=RetryConfig(max_retries=2))
    nag_free = None
    for name, fkw in SERVE_FAULTS.items():
        fault = FaultSpec(seed=3, **fkw)
        pol = ResilientPolicy(build(), remote=FaultyRemote(fault), resilience=rcfg)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = replay_resilient(pol, reqs, batch=SERVE_BATCH)
        dt = time.perf_counter() - t0
        SERVING_SHAPES.update(ops.SHAPE_LAUNCHES)
        nag = pol.normalized_gain(res["gain"].sum(), res["requests"])
        c = res["counters"]
        cpu = RemoteSession(FaultyRemote(fault), rcfg)
        for _ in range(res["requests"] // SERVE_BATCH):
            cpu.simulate_batch(SERVE_BATCH)
        want = cpu.counters.to_dict()
        schedule = [f for f in want if f not in ("degraded", "shed")]
        log(f"serving (b) {name}: NAG={nag} ratio to fault free="
            f"{None if nag_free is None else nag / nag_free} degraded_share="
            f"{res['degraded_share']} shed_share={res['shed_share']} goodput="
            f"{res['goodput']} virtual p50={res['p50_ms']} ms p99={res['p99_ms']} ms "
            f"counters={c} breaker_transitions={res['breaker_transitions']} "
            f"us/request={dt / res['requests'] * 1e6} p50_step_us={res['p50_step_s'] * 1e6}")
        if name == "fault_free":
            nag_free = nag
            same = (bool((res["gain"] == ref["gain"]).all())
                    and torch.equal(pol.inner.cache.state.y, plain.cache.state.y)
                    and torch.equal(pol.inner.cache.state.x, plain.cache.state.x))
            log(f"serving (b) fault_free equals the plain replay bit for bit "
                f"(gain, y, x): {same}")
            if not same:
                raise AssertionError("serving resilience: the fault-free path differs "
                                     "from the plain replay")
        if any(c[f] != want[f] for f in schedule):
            raise AssertionError(f"serving resilience {name}: counters {c} differ from "
                                 f"the CPU session's {want}")
        if c["degraded"] + c["shed"] != c["remote_failures"]:
            raise AssertionError(f"serving resilience {name}: degraded + shed != failures")
        if name != "fault_free" and not c["remote_failures"]:
            raise AssertionError(f"serving resilience {name}: no remote failure")
    log("serving (b): the schedule's counters equal a CPU session's with the same "
        "FaultSpec")


def serving_engine(torch, ops, dev, cat, reqs, c_f, state0) -> None:
    """(c) the online engine at 1M: AÇAI over flat, poisson and flash_crowd
    at SERVE_LOADS of capacity_rps(8) and the closed loop, under the
    reference's service model and one fitted to the card's steps; the
    fixed-window engine against AcaiPolicy.replay bit for bit."""
    import numpy as np

    from repro_torch.core import policy
    from repro_torch.core import policy_api as PA
    from repro_torch.core.costs import CostModel
    from repro_torch.index.base import IndexSpec
    from repro_torch.serve.arrivals import ArrivalSpec
    from repro_torch.serve.queue import (AdmissionConfig, BatchFormerConfig,
                                         OnlineServingEngine, ServiceModel,
                                         fixed_window_engine)

    spec = PA.PolicySpec("acai", {"h": H_FULL, "k": K_FULL, "batch": SERVE_BATCH})

    def build(batch=SERVE_BATCH):
        p = PA.build_policy(spec.with_params(batch=batch), cat, CostModel(c_f=c_f),
                            index_spec=IndexSpec("flat"), seed=0, device=dev)
        p.cache.state = policy.copy_state(state0, seed=0)
        return p

    # the fixed-window pin
    a, b = build(), build()
    ops.reset_launches()
    res = fixed_window_engine(a, SERVE_BATCH).run(
        reqs, ArrivalSpec(kind="poisson", rate_rps=1600.0, seed=11))
    ref = b.replay(reqs)
    SERVING_SHAPES.update(ops.SHAPE_LAUNCHES)
    same = (bool((res["gain"] == ref["gain"]).all())
            and torch.equal(a.cache.state.y, b.cache.state.y)
            and torch.equal(a.cache.state.x, b.cache.state.x))
    log(f"serving (c) fixed-window engine equals AcaiPolicy.replay bit for bit (gain, y, "
        f"x): {same}")
    if not same:
        raise AssertionError("serving engine: the fixed-window engine differs from the "
                             "replay")
    # the card's step at B 8 and 64 (median of 16 steps on copies of one
    # state, the card synchronised around each), fitted to base + per b
    step_ms = {}
    for bb in (8, 64):
        p = build(bb)
        rs = torch.from_numpy(reqs[:bb]).to(dev)
        times = []
        for i in range(18):
            p.cache.state = policy.copy_state(state0, seed=i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p.cache.serve_update_batch(rs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        step_ms[bb] = float(np.median(times[2:])) * 1e3
    fitted = ServiceModel.fit(step_ms)
    log(f"serving (c) step on the card: B 8 {step_ms[8]} ms, B 64 {step_ms[64]} ms -> "
        f"fitted service model base {fitted.base_ms} ms + {fitted.per_request_ms} ms a "
        f"request (capacity {fitted.capacity_rps(SERVE_BATCH)} requests/s at B 8); the "
        f"reference's: {ServiceModel().to_dict()} ({ServiceModel().capacity_rps(8)} "
        f"requests/s)")
    for label, service in (("reference", ServiceModel()), ("fitted", fitted)):
        cap = service.capacity_rps(SERVE_BATCH)
        cells = [(kind, load) for kind in ("poisson", "flash_crowd") for load in SERVE_LOADS]
        cells.append(("closed_loop", None))
        for kind, load in cells:
            arrival = (ArrivalSpec(kind=kind, users=2 * SERVE_BATCH, think_ms=2.0, seed=11)
                       if kind == "closed_loop"
                       else ArrivalSpec(kind=kind, rate_rps=load * cap, seed=11))
            p = build()
            ops.reset_launches()
            out = OnlineServingEngine(
                p, former=BatchFormerConfig(SERVE_BATCH, SERVE_WINDOW_MS),
                admission=AdmissionConfig(queue_cap=SERVE_QUEUE_CAP),
                service=service).run(reqs, arrival, slo_ms=SERVE_SLO_MS)
            SERVING_SHAPES.update(ops.SHAPE_LAUNCHES)
            served = max(out["served"], 1)
            nag = float(out["gain"].sum()) / (p.k * p.c_f * served)
            log(f"serving (c) {label} service, {kind} load={load}: p50={out['p50_ms']} "
                f"p99={out['p99_ms']} p99.9={out['p999_ms']} ms (virtual) "
                f"goodput@{SERVE_SLO_MS}ms={out['goodput_slo']} "
                f"shed_share={out['shed_share']} mean_batch={out['mean_batch']} "
                f"batches={out['batches']} step wall p50={out['p50_step_s'] * 1e3} ms "
                f"(synchronised) NAG(served)={nag}")
            if not (np.isfinite(out["gain"]).all() and out["served"] + out["shed_total"]
                    == out["requests"] == T_FULL):
                raise AssertionError(f"serving engine {label} {kind} {load}: bad result")


def serving_small(torch, ops, dev) -> None:
    """The n 2000 x 16 settings of BENCH_serving.json, BENCH_resilience.json
    and BENCH_answer_cache.json, every registered policy on the card and
    through the CPU port (AÇAI's uniforms injected alike): every
    virtual-clock field equal, NAG within CARD_CPU_TOL; the differences
    from the reference's files logged (AÇAI within ACAI_TOL, the baselines
    within BASELINE_TOL)."""
    import numpy as np

    from repro_torch.core import policy_api as PA
    from repro_torch.core import trace
    from repro_torch.core.costs import CostModel
    from repro_torch.index.base import IndexSpec
    from repro_torch.serve.answer_cache import AnswerCacheSpec
    from repro_torch.serve.arrivals import ArrivalSpec
    from repro_torch.serve.queue import (AdmissionConfig, BatchFormerConfig,
                                         OnlineServingEngine, ServiceModel)
    from repro_torch.serve.remote import FaultSpec, FaultyRemote
    from repro_torch.serve.resilience import (BreakerConfig, ResilienceConfig,
                                              ResilientPolicy, replay_resilient)

    serving = json.loads(BENCH_SERVING.read_text())
    resil = json.loads(BENCH_RESILIENCE.read_text())
    answer = json.loads(BENCH_ANSWER.read_text())
    n, d, t, h, k = (serving[f] for f in ("n", "d", "t", "h", "k"))
    c_f = serving["c_f"]
    cm = CostModel(c_f=c_f)
    cat, reqs, _ = trace.sift_like(n=n, d=d, t=t, jitter=0.05, seed=17)
    specs = {"acai": PA.PolicySpec("acai", {"h": h, "k": k, "batch": 8}),
             "sim_lru": PA.PolicySpec("sim_lru", {"h": h, "k": k, "k_prime": 2 * k,
                                                  "c_theta": 1.5 * c_f}),
             "qcache": PA.PolicySpec("qcache", {"h": h, "k": k}),
             "lru": PA.PolicySpec("lru", {"h": h, "k": k}),
             "cls_lru": PA.PolicySpec("cls_lru", {"h": h, "k": k, "k_prime": 2 * k,
                                                  "c_theta": 1.5 * c_f}),
             "rnd_lru": PA.PolicySpec("rnd_lru", {"h": h, "k": k, "k_prime": 2 * k,
                                                  "c_theta": 1.5 * c_f})}
    in_files = ("acai", "sim_lru", "qcache")
    worst = {"card_cpu": 0.0, "acai_file": 0.0, "baseline_file": 0.0}

    def policy(label, where, answer_cache=None, index_spec=None, catalog=cat):
        p = PA.build_policy(specs[label], catalog, cm, seed=0, device=where,
                            answer_cache=answer_cache, index_spec=index_spec)
        return InjectedUniforms(p, seed=5) if label == "acai" else p

    def file_diff(label, nag, want, what):
        if want is None:
            return
        diff = abs(nag - want)
        kind = "acai_file" if label == "acai" else "baseline_file"
        worst[kind] = max(worst[kind], diff)
        log(f"  serving n=2000 {what}: NAG {nag} reference file {want} |diff|={diff}")
        if diff > (ACAI_TOL if label == "acai" else BASELINE_TOL):
            raise AssertionError(f"serving n=2000 {what}: NAG {nag} against the "
                                 f"reference file's {want}")

    def both(run, what, fields, label, want=None):
        out = {where: run(where) for where in ("cpu", dev)}
        for f in fields:
            a, b = out["cpu"][f], out[dev][f]
            same = (np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b)
            if not same:
                raise AssertionError(f"serving n=2000 {what}: {f} differs card against CPU")
        nags = {w: o["nag"] for w, o in out.items()}
        diff = abs(nags["cpu"] - nags[dev])
        worst["card_cpu"] = max(worst["card_cpu"], diff)
        shown = {f: (f"{len(v)} entries" if isinstance(v, list) else v)
                 for f, v in ((f, out[dev][f]) for f in fields)
                 if not isinstance(v, np.ndarray)}
        log(f"serving n=2000 {what}: NAG cpu={nags['cpu']} cuda={nags[dev]} |diff|={diff}; "
            + ", ".join(f"{f}={v}" for f, v in shown.items()))
        if diff > CARD_CPU_TOL:
            raise AssertionError(f"serving n=2000 {what}: NAG card against CPU")
        file_diff(label, nags[dev], want, what)

    # BENCH_serving.json: every policy under poisson 0.8 and the closed
    # loop, the file's three also under flash_crowd 1.2
    service = ServiceModel(**serving["service"])
    rows = {(r["label"], r["arrival"]["kind"], r["offered_load"]): r for r in serving["rows"]}
    grid = [(label, "poisson", 0.8) for label in specs]
    grid += [(label, "closed_loop", None) for label in specs]
    grid += [(label, "flash_crowd", 1.2) for label in in_files]
    eng_fields = ("arrival_ms", "form_ms", "done_ms", "latency_ms", "shed", "p50_ms",
                  "p99_ms", "p999_ms", "batch_hist", "shed_share", "goodput_slo",
                  "mean_batch", "max_queue_depth")
    for label, kind, load in grid:
        arrival = (ArrivalSpec(kind="closed_loop", users=16, think_ms=2.0,
                               seed=serving["arrival_seed"]) if kind == "closed_loop"
                   else ArrivalSpec(kind=kind, rate_rps=load * serving["capacity_rps"],
                                    seed=serving["arrival_seed"]))

        def run(where, label=label, arrival=arrival):
            p = policy(label, where)
            ops.reset_launches()
            o = OnlineServingEngine(p, former=BatchFormerConfig(8, serving["window_ms"]),
                                    admission=AdmissionConfig(queue_cap=serving["queue_cap"]),
                                    service=service).run(reqs, arrival,
                                                         slo_ms=serving["slo_ms"])
            o["nag"] = float(o["gain"].sum()) / (p.k * p.c_f * max(o["served"], 1))
            o["batch_hist"] = {str(a): b for a, b in o["batch_hist"].items()}
            return o

        row = rows.get((label, kind, load))
        both(run, f"serving {label} {kind} {load}", eng_fields, label,
             None if row is None else row["nag"])

    # BENCH_resilience.json: every policy under the outage, the file's
    # three also flaky and slow_spikes
    base = dict(latency_ms=5.0, seed=3)
    scen = {"flaky": (FaultSpec(error_rate=0.15, **base), ResilienceConfig(deadline_ms=250.0)),
            "slow_spikes": (FaultSpec(latency_ms=40.0, latency_sigma=0.3, spike_every=64,
                                      spike_width=16, spike_ms=400.0, seed=3),
                            ResilienceConfig(deadline_ms=250.0, hedge_ms=80.0,
                                             breaker=BreakerConfig(cooldown_requests=48))),
            "outage": (FaultSpec(outages=((int(0.4 * t), int(0.6 * t)),), **base),
                       ResilienceConfig(deadline_ms=250.0))}
    rrows = {(r["label"], r["scenario"]): r for r in resil["rows"]}
    cells = [(label, "outage") for label in specs]
    cells += [(label, s) for label in in_files for s in ("flaky", "slow_spikes")]
    res_fields = ("degraded", "shed", "remote_failures", "retries", "deadline_misses",
                  "counters", "breaker_log", "p50_ms", "p99_ms", "goodput",
                  "degraded_share", "shed_share")
    for label, s in cells:
        fault, rcfg = scen[s]

        def run(where, label=label, fault=fault, rcfg=rcfg):
            p = policy(label, where)
            inner = p.pol if label == "acai" else p
            rp = ResilientPolicy(inner, remote=FaultyRemote(fault), resilience=rcfg)
            us = (np.stack([step_uniforms(5, i, n).numpy() for i in range(t // 8)])
                  if label == "acai" else None)
            o = replay_resilient(rp, reqs, batch=8,
                                 uniforms=None if us is None else torch.from_numpy(us).to(
                                     where))
            o["nag"] = float(o["gain"].sum()) / (rp.k * rp.c_f * o["requests"])
            return o

        row = rrows.get((label, s))
        both(run, f"resilience {label} {s}", res_fields, label,
             None if row is None else row["nag"])

    # BENCH_answer_cache.json: AÇAI over flat on the Zipf trace and the
    # rolling catalog, the cache on and in pass-through, and the engine's
    # fast path
    from repro_torch.core import churn

    zcat, zreqs, _ = trace.sift_like(n=n, d=d, t=t, zipf_a=answer["zipf_a"], jitter=0.0,
                                     seed=17)
    rcat, rreqs, _ = trace.rolling_catalog(n=n, d=d, t=t, churn_rate=answer["churn_rate"],
                                           warm=answer["churn_warm"], seed=17)
    revents = trace.rolling_catalog_events(n=n, t=t, churn_rate=answer["churn_rate"],
                                           warm=answer["churn_warm"])
    n_warm = churn.warm_size(n, answer["churn_warm"])
    arows = {(r["scenario"], r["index"]["backend"], r["cache"]): r for r in answer["rows"]}
    ac_fields = ("answer_hits", "hit_rate", "invalidations", "inv_remove", "inv_add",
                 "scans_skipped")
    for scenario in ("zipf", "rolling_catalog"):
        for cap in (answer["answer_capacity"], 0):
            def run(where, scenario=scenario, cap=cap):
                spec = AnswerCacheSpec(capacity=cap)
                if scenario == "zipf":
                    p = policy("acai", where, spec, IndexSpec("flat"), zcat)
                    r = PA.replay_trace_steps(p, zreqs, batch=8)
                else:
                    p = policy("acai", where, spec, IndexSpec("flat"), rcat[:n_warm]).pol
                    r = churn.replay_with_churn(p, rcat, rreqs, revents, batch=8,
                                                uniforms_fn=lambda i, nn: step_uniforms(
                                                    5, i, nn))
                st = p.answer_cache.stats()
                o = {f: st[f] for f in ac_fields[1:]}
                o["answer_hits"] = st["hits"]
                o["nag"] = p.normalized_gain(float(r["gain"].sum()), r["requests"])
                return o

            row = arows.get((scenario, "flat", "on" if cap else "off"))
            both(run, f"answer cache {scenario} flat {'on' if cap else 'off'}", ac_fields,
                 "acai", None if row is None else row["nag"])

    def run_engine(where):
        p = policy("acai", where, AnswerCacheSpec(capacity=answer["answer_capacity"]),
                   IndexSpec("flat"), zcat)
        sm = ServiceModel()
        o = OnlineServingEngine(p, former=BatchFormerConfig(8, 5.0), service=sm).run(
            zreqs, ArrivalSpec(kind="poisson", rate_rps=0.8 * sm.capacity_rps(8),
                               seed=answer["arrival_seed"]))
        o["nag"] = p.normalized_gain(float(o["gain"].sum()), o["requests"])
        return o

    both(run_engine, "answer cache engine fast path",
         ("answer_hit", "answer_hit_rate", "p50_user_ms", "p99_user_ms", "p50_hit_ms",
          "p50_miss_ms", "user_latency_ms"), "acai")
    log(f"serving n=2000: worst |NAG diff| card against CPU {worst['card_cpu']} "
        f"(<= {CARD_CPU_TOL}); against the reference files: AÇAI {worst['acai_file']} "
        f"(<= {ACAI_TOL}), baselines {worst['baseline_file']} (<= {BASELINE_TOL})")


def serving_phase(torch, ops, dev):
    """The serving tier on the card: (a) the answer cache on
    answer_cache_bench.py's Zipf and flash-crowd traces and its rolling
    catalog, (b) the resilient tier and (c) the online engine on the
    slice's sift_like, all at 1M x 128; then the n 2000 parity against the
    CPU port and the reference's files.  Launches are counted by shape into
    SERVING_SHAPES (the rolling catalog's into SERVING_CHURN_SHAPES)."""
    from repro_torch.core import oma, policy, trace
    from repro_torch.core.costs import calibrate_fetch_cost

    t_phase = time.perf_counter()
    traces = {}
    for name, make, backends in (
            ("zipf", lambda: trace.sift_like(**SERVE_ZIPF), ("flat", "ivf", "ivfpq")),
            ("flash_crowd", lambda: trace.flash_crowd(**SERVE_CROWD), ("flat", "ivf"))):
        t0 = time.perf_counter()
        cat, reqs, ids = make()
        c_f = calibrate_fetch_cost(cat, kth=50, device=dev)
        traces[name] = (cat, reqs, c_f, backends)
        log(f"serving: {name} {N_FULL} x {D_FULL}: {len(set(ids.tolist()))} distinct "
            f"objects in {T_FULL} requests, c_f {c_f} ({time.perf_counter() - t0} s)")
    cfg = policy.AcaiConfig(h=H_FULL, k=K_FULL, c_f=1.0)
    state0 = policy.init_state(N_FULL, cfg, seed=0, device=dev)
    total = Counter()
    t0 = time.perf_counter()
    serving_answer_cache(torch, ops, dev, traces, state0)
    log(f"serving: (a) answer cache {time.perf_counter() - t0} s")
    del traces
    t0 = time.perf_counter()
    serving_churn(torch, ops, dev)
    log(f"serving: (a) rolling catalog {time.perf_counter() - t0} s")
    t0 = time.perf_counter()
    cat, reqs, _ = trace.sift_like(n=N_FULL, d=D_FULL, t=T_FULL, seed=0)
    c_f = calibrate_fetch_cost(cat, kth=50, device=dev)
    log(f"serving: the slice's sift_like {N_FULL} x {D_FULL}, c_f {c_f} "
        f"({time.perf_counter() - t0} s)")
    t0 = time.perf_counter()
    serving_resilience(torch, ops, dev, cat, reqs, c_f, state0)
    log(f"serving: (b) resilience {time.perf_counter() - t0} s")
    t0 = time.perf_counter()
    serving_engine(torch, ops, dev, cat, reqs, c_f, state0)
    log(f"serving: (c) online engine {time.perf_counter() - t0} s")
    del cat, reqs, state0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serving_small(torch, ops, dev)
    log(f"serving: n=2000 card against CPU {time.perf_counter() - t0} s")
    for (name, _), v in list(SERVING_SHAPES.items()) + list(SERVING_CHURN_SHAPES.items()):
        total[name] += v
    log(f"serving: phase {time.perf_counter() - t_phase} s; launches at 1M {dict(total)}")


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
    """qwen1.5-0.5b at full width through the launcher (launches counted by
    shape into MAIN_SHAPES)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lm_serve

    n_layers = get_config(LM_ARCH).n_layers
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
        MAIN_SHAPES.update(ops.SHAPE_LAUNCHES)


def main() -> int:
    only = sys.argv[1:] == ["--only", "serving"]
    if sys.argv[1:] and not only:
        print("usage: chip_smoke.py [--only serving]", file=sys.stderr)
        return 2
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

    if only:
        # a quick look at one phase while it is worked on: no kernels line
        # and no result line
        serving_phase(torch, ops, dev)
        log(f"total: {time.perf_counter() - t_start} s (--only serving: no result)")
        return 0

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
    slice_phase(torch, ops, cat_np, reqs_np, dev)
    policies_phase(torch, ops, cat_np, reqs_np, dev)
    del cat_np, reqs_np
    torch.cuda.empty_cache()
    churn_cases = churn_phase(torch, ops, ref, dev)
    serving_phase(torch, ops, dev)
    MAIN_SHAPES.update(SERVING_SHAPES)
    CHURN_SHAPES.update(SERVING_CHURN_SHAPES)

    flash_phase(torch, ops, ref, dev)
    topk_wide_phase(torch, ops, ref, dev)
    torch.cuda.empty_cache()
    lm_parity_phase(torch, ops, dev)
    lm_slice_phase(torch, ops, card)
    # last: once torch.profiler has traced the card, every later launch in
    # this process pays its callbacks, so no host-clock figure comes after
    rows = shapes_phase(torch, ops, ref, catalog, reqs, ivf_index, pq_index, dev,
                        churn_cases)
    del ivf_index, pq_index, catalog, reqs, churn_cases
    for name in sorted({k for k, _ in MAIN_SHAPES}):
        total = sum(n for (k, _), n in MAIN_SHAPES.items() if k == name)
        log(f"main path {name}: {total} launches; by shape: "
            + ", ".join(f"{dims} x {n}" for (k, dims), n in sorted(MAIN_SHAPES.items())
                        if k == name))
    for name in sorted({k for k, _ in CHURN_SHAPES}):
        total = sum(n for (k, _), n in CHURN_SHAPES.items() if k == name)
        log(f"churn path {name}: {total} launches; by shape: "
            + ", ".join(f"{dims} x {n}" for (k, dims), n in sorted(CHURN_SHAPES.items())
                        if k == name))
    # the serving phase's shapes: each a row's (none expected new: they
    # are the retrieval slice's and the churn path's)
    for counts in (SERVING_SHAPES, SERVING_CHURN_SHAPES):
        for (name, dims), n in sorted(counts.items()):
            rowed = any(shape_launches(Counter({(name, dims): 1}), *r["key"])
                        for r in rows)
            log(f"serving path {name} {dims} x {n}: "
                f"{'a row of the kernels line' if rowed else 'NEW to the main path, no row'}")
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
