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
             `ivf_scan_lists` equal to it on small-integer ties; `ivf_scan`
             (one clustered launch a call, ids out) at the IVF-PQ re-rank's
             B 8 and 64 with 10% tombstoned and at k 64 / 160 / 400 / 1024,
             on an LSH table at n 2000 and on the probe table of a batch (a
             cluster of 16 blocks), and, in the shapes phase, one device
             kernel a call with and without `valid` (torch.profiler);
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
5b. figures — the paper's figure grids and its regret check
             (`repro_torch.experiments`' fig1-fig8, `repro_torch.regret`):
             (a) every cell of each grid over its own traces at the reduced
             sweep lists, n 2000 and 512 requests, on the card, each grid's
             summary lines printed, no NaN NAG, no baseline above h; fig7's
             sift_like cells (plain baselines, augmented twins, AÇAI with
             one injected state and uniform set) card against the CPU port
             at the card's c_f, NAG to 1e-3; (b) fig1's sift_like cell set
             (AÇAI, the 27 tuned SIM / CLS / RND-LRU cells, LRU, QCACHE) at
             the slice's 1M x 128, h 400, k 10 over the policies phase's
             oracle (kmax 128): no `l2_topk` launch inside any replay,
             `improvement_vs_2nd` printed, launches by shape counted with
             the main path's; (c) Theorem IV.1's psi-regret a step at T
             500 / 1500 / 4000 (n 4000, h 100, k 10) and whether it decays.
             `--only figures` runs the build and this phase alone (its own
             c_f and oracle) and prints no result;
6. churn  — the mutable catalog (benchmarks/churn_bench.py --full's
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
             never;
10. lm archs — the other six architectures card against CPU at SMOKE, the
             flash kernels at their widths (hubert's (80, 80) in bf16 on the
             wgmma kernel, in float32 on the FMA one), and each at full
             width with its depth cut (hubert's encoder: its two flash
             launches on the wgmma kernel at its key, none on the FMA one);
11. train  — (c) the C5 checks: `topk_l2` (10% tombstoned), `ivf_scan_topk`
             and `ivf_scan_lists` at k 160, 400 and 1024 against their plain
             versions at k + 1, and ServerOracle(kmax=160) at 1M x 128 (4
             `l2_topk` launches at 512 x 1M x 128, k 160); (b) one training
             step at SMOKE size in float32 with flash forced, card against
             CPU, for qwen1.5-0.5b, mixtral (MoE, Adafactor), deepseek-v3
             (MLA + MTP) and mamba2 (SSD): loss, grad norm and every leaf's
             gradient to 1e-4; (a) qwen1.5-0.5b at full width (24 layers,
             bf16, AdamW) through `repro_torch.launch.train.main` at 8192
             tokens: 6 steps at batch 1 (the last loss below the first) and
             2 at accum 2 over batch 2, 48 (96) `flash_attention_wgmma`
             launches a step at the training key, every wq / wk / wv / bias
             gradient finite and nonzero, step ms and peak memory; after
             the shapes phase, a profiled step: the attention backward's
             share of the step (torch.profiler);
12. sharded — AÇAI's sharded step (repro_torch.core.distributed) on a
             one-rank NCCL world (file:// store in a temporary directory,
             the (1, 1) mesh, destroyed at the phase's end) at the slice's
             1M x 128, h 400, k 10, c_remote 64, c_local 16, projection
             over the top 2h + 64, B 8 and 64: (a) exact, AcaiCache(mesh=)
             against AcaiCache (single, mesh, mesh, single; the same
             uniforms): y, x, t and every StepMetrics field equal bit for
             bit, {"all_gather": 2, "all_reduce": 1} and one pairwise_l2
             launch a step, µs/request and NAG of both arms; (b) scan_chunk
             > 0: one l2_topk launch a step, {"all_gather": 3,
             "all_reduce": 1}, NAG within 1e-3 of (a), remote ids held to
             the plain version at k + 1; (c) ivf_sharded at nlist 256,
             nprobe 16, trained once and loaded into both arms (the other
             IVFFlatIndex on the same lists): one ivf_scan launch a step
             and no ivf_scan_lists one, {"all_gather": 3, "all_reduce":
             1}, NAG within 1e-3, the probe's decided ids equal to
             ref.ivf_scan_ref's; (d) the churn phase's rolling catalog,
             its first 512 requests through replay_with_churn on both
             arms: equal bit for bit; (e) the step's collectives at B 8:
             call times (CUDA events, host clock) here, device times
             (torch.profiler) after the shapes phase in a world of their
             own.  Its shapes that no full-width row has (the exact scan at
             B 64, the shard's IVF table) join the kernels line, and so
             does each kernel at a 4-card shard's shape (250000 rows) on
             one card, with 0 launches.  `--only sharded` runs the build
             and this phase alone and prints no result;
13. moe_ep — the expert-parallel MoE (repro_torch.models.moe under
             repro_torch.sharding.ctx.mesh_context) on a one-rank NCCL
             world: (a) mixtral-8x22b at its published widths, 2 of 56
             layers, weights from seed 0, moe_dp 16, through ServeEngine at
             batch 2 (two 8192-token prompts, 32 decode steps) under the
             (1, 1) mesh against the same engine with no mesh and moe_dp 0:
             every prefill's logits equal bit for bit (the shard_map
             branch), every decode token equal (the single-stage branch),
             4 all-gathers and 2 all-reduces a MoE layer and call, two
             wgmma flash launches a prefill; (b) jamba-1.5-large's MoE
             layer at full width in bf16 (16 experts x 3 x 8192 x 24576,
             drawn on the card), 8192 tokens, capacity factor 1.25: the
             (1, 1)-mesh layer and the four shares of a (1, 4) mesh
             (`moe_local` on views of the same weights, summed in rank
             order) each equal to the single-stage layer bit for bit, each
             share timed (CUDA events), peak memory.  `--only moe_ep` runs
             the build and this phase alone and prints no result;
14. tp — the specs' layout (repro_torch.sharding.tp: tensor-parallel
             attention and FFN, the vocab-parallel embedding and head,
             fsdp): (a) qwen2-72b at its published widths, 4 of 80 layers,
             weights from seed 0, through ServeEngine at batch 2 (two
             8192-token prompts into a 10240-token cache, 32 decode steps)
             under the one-rank NCCL (1, 1) mesh against the unmeshed
             engine: tokens equal, logits within 1e-3 of their largest, the
             collectives of a prefill and of a decode step pinned by site;
             (b) one full-width qwen2-72b layer over 8192 tokens, whole and
             as the four shares of a (1, 4) mesh (attention_local /
             mlp_local on convert.block_views: 16 heads, 2 kv heads, d_ff
             7392 a share) summed in rank order, and the vocab-parallel
             embedding and head as four 38016-row shares, each share timed
             (CUDA events); (c) qwen1.5-0.5b trained at full width over
             8192 tokens, 6 steps, on the (1, 1) mesh against the unmeshed
             steps (losses within 1e-4 relative), collectives a step and
             step times; (d) deepseek-v3 (MLA + MoE) at its published
             widths, 4 of 61 layers, two 8000-token prompts into 8192, 16
             decode steps with each MLA decode path, and (e) mamba2-130m's
             24 layers, two 8192-token prompts, 32 steps, each through the
             (1, 1) mesh against the unmeshed engine: logits and tokens
             equal bit for bit, the collectives of a prefill and of a
             decode step pinned by site, deepseek-v3's wgmma flash launches
             at (192, 128); (f) one deepseek-v3 MLA layer and one
             jamba-1.5-large Mamba2 layer at full width over 8192 tokens,
             whole and as the four shares of a (1, 4) mesh (the collectives
             by hand in rank order), summed against the whole, each share
             timed (CUDA events), the MLA shares' flash launches at 32 heads
             on the main path; (g) SMOKE deepseek-v3 (with MTP) and jamba,
             float32, a training step on the (1, 1) mesh against the plain
             step.  `--only tp` runs the build and this phase alone and
             prints no result;
15. long — long_500k's decode at global batch 1, whose 16 `data` ranks of
             the single-pod mesh each hold 1/16 of the sequence (the
             sequence-sharded cache), run as those ranks' shares one after
             another through `attention_local` (the rank's slots, its
             softmax partials) and the rank-order `combine_partials`: (a)
             jamba-1.5-large's attention layer at its published widths (d
             8192, 64 heads, 8 kv heads, bf16, seed 4) over a 524288-slot
             cache drawn from the seed, one decode step at its last slot, 16
             shares of 32768 slots; (b) mixtral-8x22b's 4096-slot ring as 16
             shares of 256, one step 1000 past the window; each against the
             whole-cache unmeshed decode: the float32 attention before the
             cast within 1e-5 of float64 over the largest |v| (the whole's
             plain float32 beside it), the layer's bf16 output within 2e-2
             of the whole's, every share and the whole timed (CUDA events);
             (c) mixtral-8x22b's MoE layer at its published widths (4.83 GB
             of bf16 experts) over 8192 tokens as 16 data shares of 512
             tokens with whole experts (`moe_share`, ROADMAP C15): 512 rows
             an expert a share against the whole's capacity of 2560, the
             concatenated outputs within 2e-2 of the single-stage layer,
             each share timed; (d) the dry-run's long_500k jamba cells on
             both production meshes in a process of the host:
             `argument_bytes` = parameters + the rank's cache + the token.
             `--only long` runs the build and this phase alone and prints
             no result;
16. cost — the dry-run's cost record (repro_torch.launch.cost, after
             every profiled phase): (a) `python -m repro_torch.launch.dryrun`
             in four processes of the card's host, side by side with (b):
             qwen2-72b prefill_32k on the single-pod mesh, deepseek-v3
             train_4k (--variant opt), mixtral-8x22b decode_32k across pods
             and the AÇAI cell, each rank 0 of a world-less production mesh
             on meta tensors, every record `ok`, its FLOPs, bytes,
             collective bytes by class and seconds printed; (b)
             qwen1.5-0.5b at its published widths (24 layers, seed 0)
             prefilling one 8192-token prompt through the (1, 1) NCCL mesh
             under the cost mode, the wgmma flash kernel launched a layer:
             FLOPs, collective calls and bytes and kernel launches equal to
             the meta count of the same program on a one-rank fake world
             (a fifth process), its matmul FLOPs within 1% of
             torch.profiler's (with_flops) over the same ops, its peak of
             live bytes within 10% of the rise of
             torch.cuda.max_memory_allocated; (c) the counted FLOPs over
             the prefill's time (CUDA events, taken before the phase's
             profiler) as TFLOP/s beside the card.  `--only cost` runs the
             build and this phase alone and prints no result.

The sharded phase's launches count with the main path's (its churn run's
with the churn path's), and so do the moe_ep and tp phases' mesh arms'
and the tp phase's (1, 4) shares'.  The
churn path's kernel rows (masked `l2_topk` over the slab, AÇAI's exact
scan over it, the add-time assignment, the masked IVF probe and IVF-PQ
shortlist on appended lists) count the churn phase's launches; the other
rows the slice's, policies', figures' and LM slice's.

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
import math
from collections import Counter
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

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
# path's flash_attention is the bf16 wgmma kernel (hubert-xlarge's (80, 80)
# included); its float32 FMA sibling (csrc/flash_attention.cu) takes float32
# at every width and bf16 at the check widths 16 / 24 / 32, off the main path
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
# the engine run's prompt lengths (LM_RUNS["engine"]'s --prompt-len), and
# the one its flash row is timed at (scripts/kernel_shapes.py's FLASH_S)
ENGINE_PROMPTS, ENGINE_TIMED_S = (2048, 8000), 4096

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


# ivf_scan at the IVF-PQ re-rank's shapes: k beyond the main path's 64 (the
# reference's benchmarks' 160 and 400, the cap), with 10% of the rows
# tombstoned; an LSH table at n 2000 (the parity phase's settings); the
# probe table (P ~66k) of a batch, which takes a cluster of 16 blocks
IVF_SCAN_K = (64, 160, 400, 1024)


def ivf_scan_checks(torch, ops, ref, catalog, reqs, ivf_index, pq_index, dev, g) -> float:
    """`ivf_scan_topk` against its plain version at k + 1: the re-rank
    tables of B 8 and 64 at IVF_SCAN_K with and without tombstones, an LSH
    table at n 2000 (and LSHIndex.query equal to the direct call), and the
    clustered probe table at B 8 with tombstones at k 64 and 1024.  Returns
    the max abs error."""
    from repro_torch.core import trace
    from repro_torch.index.lsh import LSHIndex, dedup_to_minus_one
    from repro_torch.kernels import _build

    lib = _build.load("ivf_scan")
    for d in (8, 16, 33, 128, 1024, 4096):
        if lib.ivf_scan_smem_bytes(d) != ops.ivf_scan_smem_bytes_host(d):
            raise AssertionError(f"ivf_scan smem at d={d}: host copy "
                                 f"{ops.ivf_scan_smem_bytes_host(d)}, ivf_scan.cu "
                                 f"{lib.ivf_scan_smem_bytes(d)}")
    log("  ivf_scan's smem formula, host copy equal to the library's")
    err = 0.0
    valid = torch.rand(catalog.shape[0], device=dev, generator=g) > 0.1
    for b in (8, 64):
        q = reqs[:b].contiguous()
        short = pq_index.shortlist(q, C_REMOTE)[1].contiguous()
        for k in IVF_SCAN_K:
            for v in (None, valid):
                gd, gi = ops.ivf_scan_topk(q, catalog, short, k, valid=v)
                wd, wi = ref.ivf_scan_ref(q, catalog, short, k + 1, v)
                err = max(err, compare(
                    torch, f"ivf_scan re-rank B={b} P={short.shape[1]} k={k}"
                           f"{' 10% tombstoned' if v is not None else ''} (plan "
                           f"{ops.ivf_scan_plan(b, short.shape[1], k)})", gd, wd, (gi, wi)))
                if v is not None and bool((~v[gi.clamp_min(0).long()] & (gi >= 0)).any()):
                    raise AssertionError(f"ivf_scan re-rank B={b} k={k}: a tombstone surfaced")
    q = reqs[:8].contiguous()
    cand = ivf_index.probe_table(q)
    for k in (C_REMOTE, 1024):
        gd, gi = ops.ivf_scan_topk(q, catalog, cand, k, valid=valid)
        wd, wi = ref.ivf_scan_ref(q, catalog, cand, k + 1, valid)
        err = max(err, compare(
            torch, f"ivf_scan probe table B=8 P={cand.shape[1]} k={k} 10% tombstoned (plan "
                   f"{ops.ivf_scan_plan(8, cand.shape[1], k)})", gd, wd, (gi, wi)))
    cat, rq, _ = trace.sift_like(n=2000, d=16, t=64, seed=0)
    lsh = LSHIndex(cat, **PARITY_SPECS["lsh"], device=dev)
    for b in (8, 64):
        q = torch.from_numpy(rq[:b]).to(dev).contiguous()
        sig = torch.einsum("tbd,nd->ntb", lsh.planes, q) > 0
        codes = (sig.long() * lsh._weights).sum(-1)
        tab = torch.arange(lsh.tables, device=dev)[None, :]
        cand = dedup_to_minus_one(lsh.buckets[tab, codes].reshape(b, -1)).contiguous()
        for k in (10, C_REMOTE):
            gd, gi = ops.ivf_scan_topk(q, lsh.embeddings, cand, k)
            wd, wi = ref.ivf_scan_ref(q, lsh.embeddings, cand, k + 1)
            err = max(err, compare(
                torch, f"ivf_scan LSH table n=2000 B={b} P={cand.shape[1]} k={k} (plan "
                       f"{ops.ivf_scan_plan(b, cand.shape[1], k)})", gd, wd, (gi, wi)))
            qd, qi = lsh.query(q, k)
            if not (torch.equal(qd, gd) and torch.equal(qi, gi)):
                raise AssertionError(f"LSHIndex.query B={b} k={k}: differs from ivf_scan_topk")
    return err


def ivf_scan_kernels_a_call(torch, ops, catalog, reqs, pq_index, dev) -> None:
    """torch.profiler: one device kernel (the ivf_scan kernel) per
    `ivf_scan_topk` call at the re-rank shapes, with and without `valid`."""
    from torch.profiler import ProfilerActivity, profile

    valid = torch.ones(catalog.shape[0], dtype=torch.bool, device=dev)
    for b in (8, 64):
        q = reqs[:b].contiguous()
        short = pq_index.shortlist(q, C_REMOTE)[1].contiguous()
        for v in (None, valid):
            ops.ivf_scan_topk(q, catalog, short, C_REMOTE, valid=v)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    ops.ivf_scan_topk(q, catalog, short, C_REMOTE, valid=v)
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            what = f"ivf_scan_topk B={b}{' with valid' if v is not None else ''}"
            log(f"  {what}: {len(names)} device kernels in 10 calls: {sorted(set(names))}")
            if len(names) != 10 or not all("ivf_scan_kernel" in n for n in names):
                raise AssertionError(f"{what}: {len(names)} device kernels in 10 calls, "
                                     f"expected 10 ivf_scan kernels")


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


def shapes_phase(torch, ops, ref, catalog, reqs, ivf_index, pq_index, dev, churn_cases=(),
                 sharded_cases=()):
    """Every kernel at each main-path shape (scripts/kernel_shapes.py's
    cases, the sharded step's, then the churn path's): held against the
    plain version, then
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
    ivf_scan_kernels_a_call(torch, ops, catalog, reqs, pq_index, dev)
    cases = kernel_shapes.cases(torch, ops, ref, catalog, reqs, ivf_index, pq_index,
                                dev) + list(sharded_cases)
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
    if counter == "flash_attention_wgmma" and dims[1] == ENGINE_TIMED_S:
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
    errs["ivf_scan"] = max(errs["ivf_scan"], ivf_scan_checks(torch, ops, ref, catalog, reqs,
                                                             ivf_index, pq_index, dev, g))
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
        # the per-query kernel over the same (B, P) table: a cluster of 16
        # blocks whose runs take five passes each
        hd, hi = ops.ivf_scan_topk(q, catalog, cand, C_REMOTE)
        errs["ivf_scan"] = max(errs["ivf_scan"], compare(
            torch, f"ivf_scan probe table B={b} P={cand.shape[1]} (plan "
                   f"{ops.ivf_scan_plan(b, cand.shape[1], C_REMOTE)})", hd, wd, (hi, wi)))

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
            torch, f"ivf_scan re-rank B={b} P={short.shape[1]} (plan "
                   f"{ops.ivf_scan_plan(b, short.shape[1], C_REMOTE)})", gd, wd, (gi, wi)))

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
    shape into MAIN_SHAPES).  Returns the 1M catalog's c_f and oracle, which
    the figures phase reuses."""
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
    return c_f, oracle


# the figures phase: the eight figure grids over their own traces at the
# reduced sweep lists, at n 2000 and 512 requests; fig7's sift_like rows
# card against CPU (baselines and AÇAI, one injected state and uniform set)
FIG_SMALL = {"n": 2000, "t": 512}
FIG_CARD_CPU_TOL = 1e-3
# launches by (kernel, shape) of fig1's full-width cell set (the main path)
FIGURES_SHAPES: Counter = Counter()


def _fig_inject(torch):
    """prepare= of run_grid: an AÇAI cell starts from the host DepRound of
    its seed-0 state and takes uniforms from a seeded CPU generator, the
    same numbers on either device."""
    from repro_torch import convert
    from repro_torch.core import policy

    def prepare(pol, spec):
        if spec.name != "acai":
            return {}
        n = pol.cache.catalog.shape[0]
        st = policy.init_state(n, pol.cfg, seed=0, device="cpu")
        pol.cache.state = convert.cache_state_from_numpy(st.y.numpy(), st.x.numpy(), 0,
                                                         device=pol.cache.device)
        return {"uniforms": torch.rand(FIG_SMALL["t"] // pol.batch, n,
                                       generator=torch.Generator().manual_seed(5))}

    return prepare


def _check_rows(what, rows) -> None:
    """No NaN NAG; a baseline never holds more than h objects."""
    import numpy as np

    for r in rows:
        if not np.isfinite(r["nag_full"]):
            raise AssertionError(f"{what} {r['trace']['name']}/{r['label']}: NAG "
                                 f"{r['nag_full']}")
        if r["policy"]["policy"] != "acai" and r["occupancy_max"] > r["h"]:
            raise AssertionError(f"{what} {r['trace']['name']}/{r['label']}: occupancy "
                                 f"{r['occupancy_max']} > h {r['h']}")


def figures_phase(torch, ops, dev, catalog_np, reqs_np, c_f=None, oracle=None) -> None:
    """The paper's figure grids and its regret check on the card: (a) fig1-
    fig8 at FIG_SMALL (summary lines printed; fig7's sift_like rows card
    against CPU), (b) fig1's sift_like cell set at 1M x 128 over the
    policies phase's oracle (launches by shape into MAIN_SHAPES), (c) the
    regret check at the reference's reduced sizes."""
    import numpy as np

    from repro_torch import experiments as X
    from repro_torch import regret as R
    from repro_torch.core import baselines as B
    from repro_torch.core.costs import calibrate_fetch_cost
    from repro_torch.core.trace import TraceSpec

    t_phase = time.perf_counter()
    inject = _fig_inject(torch)
    card_rows = {}
    for name in X.FIGURES:
        t0 = time.perf_counter()
        rows = X.run_grid(X.GRIDS[name], sizes=FIG_SMALL, device=dev,
                          prepare=inject if name == "fig7" else None)
        _check_rows(f"figures {name}", rows)
        card_rows[name] = rows
        log(f"figures {name}: {len(rows)} rows on the card at n {FIG_SMALL['n']}, t "
            f"{FIG_SMALL['t']} in {time.perf_counter() - t0} s")
    # fig7's sift_like cells through the CPU port at the card's c_f (the
    # AÇAI spec carries it unrounded)
    sift = [r for r in card_rows["fig7"] if r["trace"]["name"] == "sift_like"]
    c_f7 = next(r["policy"]["c_f"] for r in sift if r["policy"]["policy"] == "acai")
    t0 = time.perf_counter()
    cpu = X.run_grid(X.GRIDS["fig7"], trace_filter="sift_like", sizes=FIG_SMALL,
                     device="cpu", calibrate=lambda cat, kth: c_f7, prepare=inject)
    if [r["label"] for r in cpu] != [r["label"] for r in sift]:
        raise AssertionError("figures fig7: the CPU rows' cells differ from the card's")
    worst = {"baseline": (0.0, ""), "acai": (0.0, "")}
    for g, c in zip(sift, cpu):
        kind = "acai" if g["policy"]["policy"] == "acai" else "baseline"
        diff = abs(g["nag_full"] - c["nag_full"])
        worst[kind] = max(worst[kind], (diff, g["label"]))
        if diff > FIG_CARD_CPU_TOL:
            raise AssertionError(f"figures fig7 {g['label']}: NAG card {g['nag_full']} "
                                 f"cpu {c['nag_full']}")
    log(f"figures fig7 sift_like card against CPU ({len(cpu)} cells, CPU {time.perf_counter() - t0} "
        f"s): max |NAG diff| baselines {worst['baseline'][0]} ({worst['baseline'][1]}), "
        f"acai {worst['acai'][0]} (<= {FIG_CARD_CPU_TOL})")

    # (b) fig1's sift_like cell set at full width over one oracle
    ops.reset_launches()
    if oracle is None:
        c_f = calibrate_fetch_cost(catalog_np, kth=50, sample=256, device=dev)
        oracle = B.ServerOracle(catalog_np, reqs_np, kmax=ORACLE_KMAX, device=dev)
    tspec = TraceSpec("sift_like", {"n": N_FULL, "d": D_FULL, "t": T_FULL})
    specs = X.GRIDS["fig1"].policy_specs(c_f, H_FULL, K_FULL, False)
    kmax = max(int(sp.params.get("k_prime") or 0) for sp in specs)
    if kmax > oracle.kmax:
        raise AssertionError(f"figures 1M: k' {kmax} above the oracle's kmax {oracle.kmax}")
    t0 = time.perf_counter()
    rows = []
    for spec in specs:
        before = ops.LAUNCHES["l2_topk"]
        r = X.run_cell("fig1", tspec, spec, catalog_np, reqs_np, oracle, c_f, 50, H_FULL, 8,
                       dev)
        rows.append(r)
        log(f"figures 1M fig1/sift_like/{spec.label}: NAG={r['nag_full']} "
            f"hit_ratio={r['hit_ratio']} us/request={r['us_per_request']} "
            f"p50_step_us={r['p50_step_us']} occupancy_max={r['occupancy_max']}")
        if ops.LAUNCHES["l2_topk"] != before:
            raise AssertionError(f"figures 1M {spec.label}: l2_topk launched "
                                 f"{ops.LAUNCHES['l2_topk'] - before} times inside the replay")
    _check_rows("figures 1M fig1", rows)
    FIGURES_SHAPES.update(ops.SHAPE_LAUNCHES)
    MAIN_SHAPES.update(ops.SHAPE_LAUNCHES)
    for label, value in X._improvement_vs_2nd(rows):
        log(f"figures 1M fig1/sift_like/{label}: {value} ({len(rows)} cells, "
            f"{time.perf_counter() - t0} s; launches {dict(ops.SHAPE_LAUNCHES)})")
    del oracle

    # (c) Theorem IV.1 at the reference's reduced sizes
    t0 = time.perf_counter()
    rates = R.main(kind="sift", device=dev)
    ts = sorted(rates)
    if not all(np.isfinite(v) for v in rates.values()):
        raise AssertionError(f"figures regret: rates {rates}")
    decays = all(rates[a] > rates[b] for a, b in zip(ts, ts[1:]))
    log(f"figures regret (n 4000, h 100, k 10): psi-regret a step "
        + ", ".join(f"T {t_len}: {rates[t_len]}" for t_len in ts)
        + f"; {'decays' if decays else 'does not decay'} with T "
        f"({time.perf_counter() - t0} s)")
    torch.cuda.empty_cache()
    log(f"figures: phase {time.perf_counter() - t_phase} s")


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

# ---------------------------------------------------------------------------
# the sharded phase: AÇAI's sharded step (repro_torch.core.distributed) on a
# one-rank NCCL world
# ---------------------------------------------------------------------------

# the slice's sift_like 1M x 128 at h 400, k 10, c_remote 64, c_local 16; the
# projection over the top 2h + 64, the sharded step's top_a (the bitwise
# contract with the single-device step); the sharded IVF at the slice's
# lists and probes; scan_chunk (the card's l2_topk scans the whole shard);
# the churn run's requests; a four-card shard's rows
SHARD_TOP_A = 2 * H_FULL + 64
SHARD_IVF = {"nlist": 256, "nprobe": 16, "train_iters": 4}
SHARD_CHUNK, SHARD_CHURN_T, SHARD_4 = 65536, 512, N_FULL // 4
SHARDED_SHAPES: Counter = Counter()
SHARDED_CHURN_SHAPES: Counter = Counter()


def nccl_world(torch):
    """A one-rank NCCL world on a file store in a temporary directory and
    its (1, 1) mesh; returns (mesh, store directory)."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh

    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    dist.init_process_group("nccl", init_method=f"file://{store}/s", rank=0, world_size=1)
    return make_host_mesh("cuda"), store


def leave_world(store) -> None:
    import shutil

    import torch.distributed as dist

    dist.destroy_process_group()
    shutil.rmtree(store, ignore_errors=True)


def serve_arm(torch, ops, D, cache, reqs, b: int):
    """The trace through `cache` in batches of b, counts from 0: (per-step
    metrics, seconds, launches, collectives, launches by shape)."""
    ops.reset_launches()
    D.reset_collectives()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms = [cache.serve_update_batch(reqs[i:i + b]) for i in range(0, reqs.shape[0], b)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return ms, dt, dict(ops.LAUNCHES), dict(D.COLLECTIVES), Counter(ops.SHAPE_LAUNCHES)


def same_run(torch, what, a, b) -> None:
    """Two runs' per-step metrics (every field) and final states equal bit
    for bit."""
    (ms_a, st_a), (ms_b, st_b) = a, b
    for i, (ma, mb) in enumerate(zip(ms_a, ms_b)):
        for f, va, vb in zip(ma._fields, ma, mb):
            same = (torch.equal(va, vb) if isinstance(va, torch.Tensor)
                    else va == vb)
            if not same:
                raise AssertionError(f"{what}: step {i} {f} differs")
    if not (torch.equal(st_a.y, st_b.y) and torch.equal(st_a.x, st_b.x)
            and st_a.t == st_b.t):
        raise AssertionError(f"{what}: final y / x / t differ")


def sharded_phase(torch, ops, ref, catalog, reqs, dev):
    """The sharded step on a (1, 1) NCCL mesh at 1M x 128, against the
    single-device cache in the same process: (a) exact, bit for bit, (b)
    scan_chunk on l2_topk, (c) ivf_sharded on ivf_scan against IVFFlatIndex
    on the same lists, (d) churn through replay_with_churn, bit for bit,
    (e) the collectives' call times.  Returns the sharded shapes' kernel
    cases (kernel_shapes.sharded_cases)."""
    import numpy as np

    import kernel_shapes
    from repro_torch.core import churn, oma, policy, trace
    from repro_torch.core import distributed as D
    from repro_torch.core.costs import calibrate_fetch_cost
    from repro_torch.index.base import IndexSpec
    from repro_torch.kernels.ref import probed_table, smallest_k

    t_phase = time.perf_counter()
    mesh, store = nccl_world(torch)
    try:
        c_f = calibrate_fetch_cost(catalog, kth=50, device=dev)
        cfg = policy.AcaiConfig(h=H_FULL, k=K_FULL, c_f=c_f, c_remote=C_REMOTE,
                                c_local=C_LOCAL,
                                oma=oma.OMAConfig(eta=0.05 / c_f, projection_topk=SHARD_TOP_A))
        state0 = policy.init_state(N_FULL, cfg, seed=0, device=dev)
        nag_single = {}

        def arm(kind, b, spec=None, **kw):
            c = dataclasses.replace(cfg, index=spec)
            cache = (policy.AcaiCache(catalog, c, device=dev, state=policy.copy_state(state0))
                     if kind == "single" else
                     policy.AcaiCache(catalog, c, mesh=mesh, state=policy.copy_state(state0),
                                      **kw))
            ms, dt, launches, coll, shapes = serve_arm(torch, ops, D, cache, reqs, b)
            if kind == "mesh":
                SHARDED_SHAPES.update(shapes)
            gain = float(torch.cat([m.gain_int for m in ms]).sum())
            nag = cache.normalized_gain(gain, reqs.shape[0])
            log(f"  sharded {kind} {c.index.backend if c.index else 'exact'} {kw or ''} "
                f"B={b}: us/request={dt / reqs.shape[0] * 1e6} NAG={nag} "
                f"launches={ {k: v for k, v in launches.items() if v} } collectives={coll}")
            return (ms, cache.state), dt, launches, coll, nag

        # (a) exact: bit for bit, the collectives and launches a step
        for b in (8, 64):
            steps = T_FULL // b
            runs = [(k, arm(k, b)) for k in ("single", "mesh", "mesh", "single")]
            first = runs[0][1][0]
            for k, r in runs[1:]:
                same_run(torch, f"sharded exact B={b} ({k} against single)", first, r[0])
            us = {k: [r[1] / T_FULL * 1e6 for kk, r in runs if kk == k]
                  for k in ("single", "mesh")}
            nag_single[("exact", b)] = runs[0][1][4]
            for k, r in runs:
                if k == "mesh" and r[3] != {"all_gather": 2 * steps, "all_reduce": steps}:
                    raise AssertionError(f"sharded exact B={b}: collectives {r[3]} in "
                                         f"{steps} steps")
                if r[2]["pairwise_l2"] != steps:
                    raise AssertionError(f"sharded exact B={b} {k}: {r[2]['pairwise_l2']} "
                                         f"pairwise_l2 launches in {steps} steps")
            log(f"sharded (a) exact B={b}: bit for bit equal to the single-device step "
                f"(y, x, t, every StepMetrics field); us/request single={us['single']} "
                f"mesh={us['mesh']}; NAG {runs[0][1][4]}; 2 all_gather + 1 all_reduce and "
                f"1 pairwise_l2 launch a step")

        # (b) scan_chunk: the l2_topk kernel, one launch a step
        for b in (8, 64):
            steps = T_FULL // b
            r = arm("mesh", b, sharded_kwargs={"scan_chunk": SHARD_CHUNK})
            if r[3] != {"all_gather": 3 * steps, "all_reduce": steps}:
                raise AssertionError(f"sharded scan_chunk B={b}: collectives {r[3]}")
            if r[2]["l2_topk"] != steps:
                raise AssertionError(f"sharded scan_chunk B={b}: {r[2]['l2_topk']} l2_topk "
                                     f"launches in {steps} steps")
            diff = abs(r[4] - nag_single[("exact", b)])
            log(f"sharded (b) scan_chunk B={b}: NAG {r[4]}, exact {nag_single[('exact', b)]}, "
                f"|diff| {diff}")
            if diff > 1e-3:
                raise AssertionError(f"sharded scan_chunk B={b}: NAG {r[4]} against exact's "
                                     f"{nag_single[('exact', b)]}")
            q = reqs[:b].contiguous()
            gd, gi = ops.topk_l2_fused(q, catalog, C_REMOTE, chunk=SHARD_CHUNK)
            wd, wi = ref.l2_topk_ref(q, catalog, C_REMOTE + 1)
            compare(torch, f"sharded scan_chunk remote ids B={b}", gd, wd, (gi, wi))

        # (c) ivf_sharded, trained once and loaded into both arms
        t0 = time.perf_counter()
        ivf = D.build_sharded_ivf(catalog, 1, **SHARD_IVF, device=dev)
        torch.cuda.synchronize()
        lists = {"nlist": SHARD_IVF["nlist"], "nprobe": SHARD_IVF["nprobe"],
                 "centroids": ivf.centroids.cpu().numpy(), "invlists": ivf.invlists.cpu().numpy()}
        table = SHARD_IVF["nprobe"] * ivf.invlists.shape[1]
        log(f"sharded (c): ShardedIVF nlist {ivf.nlist} nprobe {ivf.nprobe}, longest list "
            f"{ivf.invlists.shape[1]}, table {table} slots a query (at most "
            f"{D.IVF_TABLE_MAX}) ({time.perf_counter() - t0} s)")
        for b in (8, 64):
            steps = T_FULL // b
            single = arm("single", b, IndexSpec("ivf", lists))
            r = arm("mesh", b, IndexSpec("ivf_sharded", lists))
            if r[3] != {"all_gather": 3 * steps, "all_reduce": steps}:
                raise AssertionError(f"sharded IVF B={b}: collectives {r[3]}")
            if r[2]["ivf_scan"] != steps or r[2]["ivf_scan_lists"]:
                raise AssertionError(f"sharded IVF B={b}: {r[2]['ivf_scan']} ivf_scan and "
                                     f"{r[2]['ivf_scan_lists']} ivf_scan_lists launches in "
                                     f"{steps} steps")
            diff = abs(r[4] - single[4])
            log(f"sharded (c) ivf_sharded B={b}: NAG {r[4]}, IVFFlatIndex on the same lists "
                f"{single[4]}, |diff| {diff}")
            if diff > 1e-3:
                raise AssertionError(f"sharded IVF B={b}: NAG {r[4]} against {single[4]}")
            q = reqs[:b].contiguous()
            probe = smallest_k(ops.pairwise_l2(q, ivf.centroids), ivf.nprobe)[1]
            cand = probed_table(ivf.invlists, probe).to(torch.int32).contiguous()
            gd, gi = ops.ivf_scan_topk(q, catalog, cand, C_REMOTE)
            wd, wi = ref.ivf_scan_ref(q, catalog, cand, C_REMOTE + 1)
            compare(torch, f"sharded IVF probe B={b} P={cand.shape[1]}", gd, wd, (gi, wi))
        del single, r

        # (d) churn: the rolling catalog's first SHARD_CHURN_T requests
        t0 = time.perf_counter()
        ccat, creqs, _ = trace.rolling_catalog(**CHURN_FULL)
        events = [e for e in trace.rolling_catalog_events(**CHURN_FULL)
                  if e[0] < SHARD_CHURN_T]
        n0 = churn.warm_size(N_FULL, CHURN_FULL["warm"])
        cc_f = calibrate_fetch_cost(ccat[:n0], kth=50, sample=256, device=dev)
        ccfg = dataclasses.replace(cfg, c_f=cc_f, oma=dataclasses.replace(
            cfg.oma, eta=0.05 / cc_f))
        cstate = policy.init_state(n0, ccfg, seed=0, device=dev)
        out = {}
        for kind in ("single", "mesh"):
            cache = (policy.AcaiCache(ccat[:n0], ccfg, device=dev,
                                      state=policy.copy_state(cstate)) if kind == "single"
                     else policy.AcaiCache(ccat[:n0], ccfg, mesh=mesh,
                                           state=policy.copy_state(cstate)))
            ops.reset_launches()
            D.reset_collectives()
            t1 = time.perf_counter()
            res = churn.replay_with_churn(cache, ccat, creqs[:SHARD_CHURN_T], events, batch=8)
            dt = time.perf_counter() - t1
            if kind == "mesh":
                SHARDED_CHURN_SHAPES.update(ops.SHAPE_LAUNCHES)
            out[kind] = (res, cache)
            log(f"  sharded churn {kind}: us/request={dt / SHARD_CHURN_T * 1e6} "
                f"NAG={cache.normalized_gain(res['gain'].sum(), res['requests'])} "
                f"events={res['events_applied']} mutation_ms={res['mutation_s'] * 1e3} "
                f"capacity={cache.catalog.shape[0]} collectives={dict(D.COLLECTIVES)} "
                f"sites={dict(D.COLLECTIVE_SITES)} launches="
                f"{ {k: v for k, v in ops.LAUNCHES.items() if v} }")
        (ra, ca), (rb, cb) = out["single"], out["mesh"]
        for k in ("gain", "cost", "served_local", "fetched", "occupancy"):
            if not np.array_equal(ra[k], rb[k]):
                raise AssertionError(f"sharded churn: {k} differs from the single-device run")
        if not (torch.equal(ca.state.y, cb.state.y) and torch.equal(ca.state.x, cb.state.x)
                and torch.equal(ca.valid, cb.valid) and torch.equal(ca.catalog, cb.catalog)):
            raise AssertionError("sharded churn: final state or slab differs")
        if not ops.LAUNCHES["pairwise_l2"]:
            raise AssertionError("sharded churn: pairwise_l2 never launched")
        log(f"sharded (d) churn: {SHARD_CHURN_T} requests, {len(events)} events, bit for bit "
            f"equal to the single-device cache ({time.perf_counter() - t0} s)")
        del out, ca, cb, ccat, creqs
        torch.cuda.empty_cache()

        # (e) the step's three collectives at B 8, call times by CUDA events
        # and on the host (device times: sharded_nccl_profile, after the
        # profiled phases)
        for what, fn in collective_calls(torch, D, mesh, dev).items():
            call = time_ms(torch, fn, 200)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(200):
                fn()
            host_us = (time.perf_counter() - t1) / 200 * 1e6
            torch.cuda.synchronize()
            log(f"sharded (e) {what}: call_ms={call} (CUDA events) host_us={host_us}")

        # the sharded shapes' kernel rows: this run's IVF, and a 4-card
        # shard's shapes on one card
        t0 = time.perf_counter()
        ivf4 = D.build_sharded_ivf(catalog[:SHARD_4], 1, **SHARD_IVF, device=dev)
        log(f"sharded: a 4-card shard's IVF over {SHARD_4} rows, longest list "
            f"{ivf4.invlists.shape[1]}, table {ivf4.nprobe * ivf4.invlists.shape[1]} slots "
            f"({time.perf_counter() - t0} s)")
        cases = kernel_shapes.sharded_cases(torch, ops, ref, reqs, [
            ("P = 1, 1M rows", catalog, ivf.shard(0) + (ivf.nprobe,), True),
            ("one kernel at a 4-card shard's shape, one card", catalog[:SHARD_4],
             ivf4.shard(0) + (ivf4.nprobe,), False)], dev)
    finally:
        leave_world(store)
    log(f"sharded: phase {time.perf_counter() - t_phase} s")
    return cases


def collective_calls(torch, D, mesh, dev) -> dict:
    """The sharded exact step's collectives at B 8, by what they carry."""
    payload = torch.zeros((8, C_REMOTE + C_LOCAL, 4), device=dev)
    heads = torch.zeros(SHARD_TOP_A + 1, device=dev)
    sums = torch.zeros(2, device=dev)
    return {f"merge all_gather {tuple(payload.shape)}":
            lambda: D.all_gather(payload, mesh, "model", "timing"),
            f"projection all_gather ({SHARD_TOP_A + 1},)":
            lambda: D.all_gather(heads, mesh, "model", "timing"),
            "rounding all_reduce (2,)": lambda: D.all_reduce(sums, mesh, "model", "timing")}


def sharded_nccl_profile(torch, dev) -> None:
    """(e) the collectives' device times (torch.profiler's NCCL kernels),
    in a one-rank NCCL world of their own; after the profiled phases."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import distributed as D

    mesh, store = nccl_world(torch)
    try:
        for what, fn in collective_calls(torch, D, mesh, dev).items():
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(100):
                    fn()
                torch.cuda.synchronize()
            nccl = [e for e in prof.key_averages() if "nccl" in e.key.lower()]
            dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in nccl)
            log(f"sharded (e) {what}: device_us={dev_us / 100} a call (torch.profiler, "
                f"NCCL events {sorted(e.key for e in nccl)})")
    finally:
        leave_world(store)



# the moe_ep phase: mixtral-8x22b at its published widths with 2 of its 56
# layers (lm_archs' cut), moe_dp 16 (the reference's single-pod
# apply_variant), two prompts of 8192 tokens (the window prefill reaches the
# flash kernel at T >= flash_threshold 8192) into a ring cache, 32 decode
# steps at batch 2; jamba-1.5-large's MoE layer at full width over 8192
# tokens, whole and as the shares of a (1, 4) mesh's four ranks
EP_LAYERS, EP_PROMPT, EP_STEPS, EP_MOE_DP = 2, 8192, 32, 16
EP_JAMBA_TOKENS, EP_JAMBA_MODEL = 8192, 4


def _event_ms(torch, fn):
    """(fn(), its device time in ms between two CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def moe_ep_mixtral(torch, ops, D, mesh, dev, card: str) -> None:
    """(a) mixtral through ServeEngine under the (1, 1) NCCL mesh against
    the same engine with no mesh and moe_dp 0: prefill logits and every
    decode token equal; the collectives of a prefill (the shard_map
    branch) and a decode step (the single-stage branch) counted."""
    import contextlib

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine
    from repro_torch.sharding.ctx import mesh_context

    full = get_config("mixtral-8x22b")
    base = dataclasses.replace(full, n_layers=EP_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params, init_ms = _timed(torch, lambda: init_params(base, seed=0, device=dev))
    n_params = sum(p.numel() for p in params.parameters())
    log(f"moe_ep (a) mixtral-8x22b [{card}]: full width, n_layers {full.n_layers} -> "
        f"{EP_LAYERS}, fsdp {base.fsdp}, {n_params} parameters drawn in {init_ms} ms")
    rng = np.random.default_rng(0)
    prompts = [torch.from_numpy(rng.integers(0, base.vocab, EP_PROMPT)) for _ in range(2)]
    # a warm-up request (unmeshed, not timed): the first prefill and decode
    # steps of a process pay one-time set-up on the card
    warm = ServeEngine(params, base, batch=2, s_max=EP_PROMPT + EP_STEPS)
    warm.submit(0, prompts[0], max_tokens=2)
    _timed(torch, lambda: sum(1 for _ in iter(warm.step, False)))
    del warm
    # and NCCL's communicator, set up at the world's first collective
    D.all_reduce(torch.zeros(1, device=dev), mesh, "model", "warm-up")
    # the (1, 1) mesh's blocks are the whole tensors: the cut records the
    # specs, which the mesh arm reads (the plain arm ignores them)
    from repro_torch import convert

    convert.shard_module(params, base, mesh)
    plain_logits, same_logits, done, figs = [], [], {}, {}
    for arm in ("plain", "mesh"):
        cfg = dataclasses.replace(base, moe_dp=EP_MOE_DP if arm == "mesh" else 0)
        each_ms = []

        def wrap(kind, fn, arm=arm, each_ms=each_ms):
            if kind != "prefill":
                return fn

            def prefill(*args):
                (logits, cache), ms = _timed(torch, lambda: fn(*args))
                each_ms.append(ms)
                if arm == "plain":
                    plain_logits.append(logits.clone())
                else:
                    same_logits.append(torch.equal(logits, plain_logits[len(same_logits)]))
                return logits, cache
            return prefill

        eng = ServeEngine(params, cfg, batch=2, s_max=EP_PROMPT + EP_STEPS, wrap=wrap)
        for i, prompt in enumerate(prompts):
            eng.submit(i, prompt, max_tokens=EP_STEPS)
        ctx = mesh_context(mesh, ("data",)) if arm == "mesh" else contextlib.nullcontext()
        with ctx:
            ops.reset_launches()
            D.reset_collectives()
            admitted, prefill_ms = _timed(torch, eng._admit)
            pre = (dict(D.COLLECTIVES), dict(ops.LAUNCHES), Counter(ops.SHAPE_LAUNCHES))
            ops.reset_launches()
            D.reset_collectives()
            steps, decode_ms = _timed(torch, lambda: sum(1 for _ in iter(eng.step, False)))
            dec = (dict(D.COLLECTIVES), dict(ops.LAUNCHES), Counter(ops.SHAPE_LAUNCHES))
        done[arm] = {k: list(v) for k, v in eng.done.items()}
        # the prefills' own times: the admission's clock also holds the
        # arms' logit copies and comparisons
        figs[arm] = (sum(each_ms) / len(each_ms), decode_ms / steps)
        log(f"  moe_ep mixtral {arm}: moe_dp {cfg.moe_dp}, prefill_ms={prefill_ms / admitted} "
            f"({admitted} prompts of {EP_PROMPT} into {EP_PROMPT + EP_STEPS}; each "
            f"prefill {each_ms} ms) "
            f"decode_steps={steps} decode_tokens_per_s={2 * steps / (decode_ms / 1e3)} "
            f"step_ms={decode_ms / steps}; prefill launches={pre[1]} collectives={pre[0]}; "
            f"decode launches={dec[1]} collectives={dec[0]} "
            f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
        if arm == "mesh":
            MAIN_SHAPES.update(pre[2])
            MAIN_SHAPES.update(dec[2])
            # a MoE layer: 4 fsdp gathers, the aux and combine all-reduces;
            # its attention: 4 fsdp gathers, the partial's all-reduce; the
            # embedding (a gather and its all-reduce) and the head (a gather)
            want_pre = {"all_gather": (8 * EP_LAYERS + 2) * admitted,
                        "all_reduce": (3 * EP_LAYERS + 1) * admitted}
            want_dec = {"all_gather": (8 * EP_LAYERS + 2) * steps,
                        "all_reduce": (3 * EP_LAYERS + 1) * steps}
            if pre[0] != want_pre or dec[0] != want_dec:
                raise AssertionError(f"moe_ep mixtral: collectives {pre[0]} a prefill run and "
                                     f"{dec[0]} a decode run, expected {want_pre} and "
                                     f"{want_dec}")
            log(f"  moe_ep mixtral collectives: a prefill "
                f"{ {k: v // admitted for k, v in pre[0].items()} }, a decode step "
                f"{ {k: v // steps for k, v in dec[0].items()} } (a layer: 8 fsdp "
                f"all-gathers and 3 all-reduces; {EP_LAYERS} layers, the embedding and the "
                f"head)")
        if pre[1].get("flash_attention_wgmma", 0) != EP_LAYERS * admitted:
            raise AssertionError(f"moe_ep mixtral {arm}: {pre[1]} launches in {admitted} "
                                 f"prefills of {EP_LAYERS} window-attention layers")
        del eng
        torch.cuda.empty_cache()
    same_tokens = sum(a == b for i in range(2) for a, b in zip(done["plain"][i],
                                                                done["mesh"][i]))
    log(f"  moe_ep mixtral: prefill logits equal bit for bit {same_logits}; {same_tokens} of "
        f"{2 * (EP_STEPS + 1)} tokens equal; the mesh adds "
        f"{figs['mesh'][0] - figs['plain'][0]} ms a prefill and "
        f"{figs['mesh'][1] - figs['plain'][1]} ms a decode step (host clock)")
    if not (len(same_logits) == 2 and all(same_logits)) or done["plain"] != done["mesh"]:
        raise AssertionError(f"moe_ep mixtral: the (1, 1) mesh differs from the unmeshed "
                             f"engine (logits {same_logits}, tokens {done})")
    del params, plain_logits
    torch.cuda.empty_cache()


def moe_ep_jamba(torch, D, mesh, dev, card: str) -> None:
    """(b) jamba-1.5-large's MoE layer at full width in bf16 over 8192
    tokens: the (1, 1)-mesh layer against the single-stage moe_ffn, then
    the four ranks' shares of a (1, 4) mesh (moe_local on views of the
    same weights) summed in rank order against it; bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.sharding.ctx import mesh_context

    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b"), moe_dp=EP_MOE_DP)
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(0)
    layer, init_ms = _timed(torch, lambda: M.init_moe(g, cfg, dev).requires_grad_(False))
    expert_bytes = sum(t.numel() * t.element_size() for t in (layer.wi, layer.wg, layer.wo))
    x = torch.randn((1, EP_JAMBA_TOKENS, cfg.d_model), generator=g, device=dev,
                    dtype=torch.bfloat16)
    log(f"moe_ep (b) jamba-1.5-large MoE layer [{card}]: d {cfg.d_model}, {cfg.n_experts} "
        f"experts x 3 x {cfg.d_model} x {cfg.moe_d_ff} ({expert_bytes} bytes bf16, drawn on "
        f"the card in {init_ms} ms), top-{cfg.experts_per_token}, capacity factor "
        f"{cfg.capacity_factor} (capacity {M.capacity(EP_JAMBA_TOKENS, cfg)}), "
        f"{EP_JAMBA_TOKENS} tokens, fsdp {cfg.fsdp}")
    single = dataclasses.replace(cfg, moe_dp=0)
    M.moe_ffn(layer, x, single)   # warm-up
    (want, want_aux), plain_ms = _event_ms(torch, lambda: M.moe_ffn(layer, x, single))
    from repro_torch import convert

    convert.moe_block(layer, cfg, mesh)   # (1, 1): whole blocks, specs recorded
    with mesh_context(mesh, ("data",)):
        M.moe_ffn(layer, x, cfg)   # warm-up: the gathers' buffers come from the allocator
        D.reset_collectives()
        (got, got_aux), mesh_ms = _event_ms(torch, lambda: M.moe_ffn(layer, x, cfg))
    coll = dict(D.COLLECTIVES)
    peak_11 = torch.cuda.max_memory_allocated()
    log(f"  moe_ep jamba (1, 1): single-stage {plain_ms} ms, the (1, 1)-mesh layer "
        f"{mesh_ms} ms (CUDA events; collectives {coll}), equal bit for bit "
        f"{torch.equal(got, want)}, aux {float(got_aux)} / {float(want_aux)}, peak memory "
        f"{peak_11}")
    if not (torch.equal(got, want) and torch.equal(got_aux, want_aux)):
        raise AssertionError(f"moe_ep jamba: the (1, 1)-mesh layer differs from moe_ffn "
                             f"(max |diff| {float((got.float() - want.float()).abs().max())})")
    if coll != {"all_gather": 4, "all_reduce": 2}:
        raise AssertionError(f"moe_ep jamba: collectives {coll}")
    del got
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    e_loc = cfg.n_experts // EP_JAMBA_MODEL
    xf = x.reshape(-1, cfg.d_model)
    M.moe_local(xf, layer.router, layer.wi[:e_loc], layer.wg[:e_loc], layer.wo[:e_loc], 0,
                EP_JAMBA_MODEL, cfg)   # warm-up
    total, share_ms, auxes = None, [], []
    for m in range(EP_JAMBA_MODEL):
        ex = slice(m * e_loc, (m + 1) * e_loc)
        (part, aux), ms = _event_ms(torch, lambda ex=ex, m=m: M.moe_local(
            xf, layer.router, layer.wi[ex], layer.wg[ex], layer.wo[ex], m, EP_JAMBA_MODEL, cfg))
        share_ms.append(ms)
        auxes.append(bool(torch.equal(aux, want_aux)))
        total = part if total is None else total + part
        del part
    total = total.reshape(x.shape)
    equal = torch.equal(total, want)
    log(f"  moe_ep jamba (1, 4) shares: e_loc {e_loc} ({expert_bytes // EP_JAMBA_MODEL} bytes "
        f"of experts a rank), ms a share {share_ms} (CUDA events), summed in rank order equal "
        f"to (1, 1) bit for bit {equal}, aux equal {auxes}, peak memory "
        f"{torch.cuda.max_memory_allocated()}")
    if not (equal and all(auxes)):
        diff = float((total.float() - want.float()).abs().max())
        raise AssertionError(f"moe_ep jamba: the (1, 4) shares' sum differs from the layer "
                             f"(max |diff| {diff})")
    del layer, x, xf, want, total
    torch.cuda.empty_cache()


def moe_ep_phase(torch, ops, dev, card: str) -> None:
    """The expert-parallel MoE on a one-rank NCCL world: (a) mixtral-8x22b
    served through the (1, 1) mesh, (b) jamba-1.5-large's MoE layer at full
    width, whole and as (1, 4) rank shares."""
    from repro_torch.core import distributed as D

    t0 = time.perf_counter()
    mesh, store = nccl_world(torch)
    try:
        moe_ep_mixtral(torch, ops, D, mesh, dev, card)
        t1 = time.perf_counter()
        log(f"moe_ep: (a) {t1 - t0} s")
        moe_ep_jamba(torch, D, mesh, dev, card)
        log(f"moe_ep: (b) {time.perf_counter() - t1} s")
    finally:
        leave_world(store)
    log(f"moe_ep: phase {time.perf_counter() - t0} s")


# the tp phase: qwen2-72b (src/repro/configs/qwen2_72b.py) at its published
# widths with 4 of its 80 layers, two prompts of 8192 tokens into a
# 10240-token cache (the flash path needs T >= flash_threshold 8192 and T %
# flash_chunk 2048 == 0), 32 decode steps at batch 2; one full-width layer,
# the embedding and the head as the four shares of a (1, 4) mesh (the head
# over the last 1024 tokens); qwen1.5-0.5b trained at full width over 8192
# tokens, batch 1, 6 steps (the train phase's cell)
TP_ARCH, TP_LAYERS, TP_PROMPT, TP_S_MAX, TP_STEPS = "qwen2-72b", 4, 8192, 10240, 32
TP_MODEL, TP_TOKENS, TP_HEAD_TOKENS, TP_TRAIN_STEPS = 4, 8192, 1024, 6
TP_TRAIN_RTOL = 1e-4
# the tp phase's MLA and Mamba2 cells: deepseek-v3 at the lm_archs phase's
# cut (DS_*: 4 of 61 layers, two 8000-token prompts into 8192, 16 steps a
# MLA decode path) and mamba2-130m's 24 layers (two 8192-token prompts, 32
# steps) on the (1, 1) mesh; one deepseek-v3 MLA layer and one
# jamba-1.5-large Mamba layer over TP_TOKENS as (1, TP_MODEL) shares; SMOKE
# deepseek-v3 and jamba trained a step (TP_SMOKE_SEQ tokens, batch 2)
TP_MAMBA_PROMPT, TP_MAMBA_STEPS, TP_SMOKE_SEQ = 8192, 32, 64


def engine_arms(torch, ops, D, mesh, cfg, params, prompts, s_max: int, steps: int) -> dict:
    """`params` through ServeEngine at batch len(prompts), with no mesh and
    under the (1, 1) NCCL mesh (`convert.shard_module` first: at one rank
    every block is the whole tensor, the same storage), each arm warmed up
    by a 2-token request: {arm: {"prefill_ms": each prefill's ms, "step_ms",
    "steps", "admitted", "pre" / "dec": (collectives by site, launches,
    launches by shape) of the admission's prefills and of the decode steps,
    "done": the finished tokens, "peak": peak memory}, "diffs": each mesh
    prefill's logits against the plain one's (equal bit for bit, max
    |diff|, max |logit|)}."""
    import contextlib

    from repro_torch import convert
    from repro_torch.serve import ServeEngine
    from repro_torch.sharding.ctx import mesh_context

    def warm():
        eng = ServeEngine(params, cfg, batch=len(prompts), s_max=s_max)
        eng.submit(0, prompts[0], max_tokens=2)
        _timed(torch, lambda: sum(1 for _ in iter(eng.step, False)))

    warm()
    D.all_reduce(torch.zeros(1, device=params.embed.device), mesh, "model", "warm-up")
    convert.shard_module(params, cfg, mesh)   # (1, 1): whole blocks, specs recorded
    with mesh_context(mesh, ("data",)):       # and the mesh arm's first calls
        warm()
    plain_logits, diffs, out = [], [], {}
    for arm in ("plain", "mesh"):
        each_ms = []

        def wrap(kind, fn, arm=arm, each_ms=each_ms):
            if kind != "prefill":
                return fn

            def prefill(*args):
                (logits, cache), ms = _timed(torch, lambda: fn(*args))
                each_ms.append(ms)
                if arm == "plain":
                    plain_logits.append(logits.clone())
                else:
                    want = plain_logits[len(diffs)]
                    diffs.append((bool(torch.equal(logits, want)),
                                  float((logits - want).abs().max()),
                                  float(want.abs().max())))
                return logits, cache
            return prefill

        torch.cuda.reset_peak_memory_stats()
        ctx = mesh_context(mesh, ("data",)) if arm == "mesh" else contextlib.nullcontext()
        with ctx:
            eng = ServeEngine(params, cfg, batch=len(prompts), s_max=s_max, wrap=wrap)
            for i, prompt in enumerate(prompts):
                eng.submit(i, prompt, max_tokens=steps)
            ops.reset_launches()
            D.reset_collectives()
            admitted, _ = _timed(torch, eng._admit)
            pre = (dict(D.COLLECTIVE_SITES), dict(ops.LAUNCHES), Counter(ops.SHAPE_LAUNCHES))
            ops.reset_launches()
            D.reset_collectives()
            n, decode_ms = _timed(torch, lambda: sum(1 for _ in iter(eng.step, False)))
            dec = (dict(D.COLLECTIVE_SITES), dict(ops.LAUNCHES), Counter(ops.SHAPE_LAUNCHES))
        out[arm] = {"prefill_ms": each_ms, "step_ms": decode_ms / n, "steps": n,
                    "admitted": admitted, "pre": pre, "dec": dec,
                    "done": {k: list(v) for k, v in eng.done.items()},
                    "peak": torch.cuda.max_memory_allocated()}
        if arm == "mesh":
            MAIN_SHAPES.update(pre[2])
            MAIN_SHAPES.update(dec[2])
        del eng
        torch.cuda.empty_cache()
    out["diffs"] = diffs
    return out


def per_call_sites(what: str, arms: dict, want: Counter) -> None:
    """The mesh arm's collectives a prefill and a decode step, by site,
    against `want` (a call's): raises on any other count."""
    mesh = arms["mesh"]
    for kind, (sites, n) in (("a prefill", (mesh["pre"][0], mesh["admitted"])),
                             ("a decode step", (mesh["dec"][0], mesh["steps"]))):
        got = {k: v // n for k, v in sites.items()}
        log(f"  {what} collectives {kind}: {got}")
        if got != dict(want) or any(v % n for v in sites.values()):
            raise AssertionError(f"{what}: collectives {sites} in {n} calls, expected "
                                 f"{dict(want)} a call")


def tp_serve(torch, ops, D, mesh, dev, card: str) -> None:
    """(a) qwen2-72b through ServeEngine under the (1, 1) NCCL mesh (the
    specs' layout: fsdp gathers, the partials' and the embedding's
    all-reduces) against the same engine with no mesh: tokens equal,
    prefill logits equal or close, the collectives of a prefill and a
    decode step pinned, the flash kernel launched once a layer a
    prefill."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    full = get_config(TP_ARCH)
    cfg = dataclasses.replace(full, n_layers=TP_LAYERS)
    params, init_ms = _timed(torch, lambda: init_params(cfg, seed=0, device=dev))
    n_params = sum(p.numel() for p in params.parameters())
    log(f"tp (a) {TP_ARCH} [{card}]: full width (d {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv_heads} kv, d_ff {cfg.d_ff}, vocab {cfg.vocab}, qkv_bias {cfg.qkv_bias}, "
        f"fsdp {cfg.fsdp}), n_layers {full.n_layers} -> {TP_LAYERS}, {n_params} parameters "
        f"({n_params * 2} bytes bf16) drawn in {init_ms} ms")
    rng = np.random.default_rng(0)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab, TP_PROMPT)) for _ in range(2)]
    arms = engine_arms(torch, ops, D, mesh, cfg, params, prompts, TP_S_MAX, TP_STEPS)
    for arm in ("plain", "mesh"):
        a = arms[arm]
        log(f"  tp qwen2-72b {arm}: prefill_ms={sum(a['prefill_ms']) / a['admitted']} "
            f"({a['admitted']} prompts of {TP_PROMPT} into {TP_S_MAX}; each prefill "
            f"{a['prefill_ms']} ms) decode_steps={a['steps']} "
            f"decode_tokens_per_s={2 / (a['step_ms'] / 1e3)} step_ms={a['step_ms']}; "
            f"prefill launches={a['pre'][1]}; decode launches={a['dec'][1]} "
            f"max_memory_allocated={a['peak']}")
        if a["pre"][1].get("flash_attention_wgmma", 0) != TP_LAYERS * a["admitted"]:
            raise AssertionError(f"tp qwen2-72b {arm}: {a['pre'][1]} launches in "
                                 f"{a['admitted']} prefills of {TP_LAYERS} layers")
    layer = {("all_gather", "fsdp"): 7, ("all_reduce", "attn_out"): 1,
             ("all_reduce", "mlp_out"): 1}
    want = Counter({k: v * TP_LAYERS for k, v in layer.items()})
    want.update({("all_gather", "fsdp"): 2, ("all_reduce", "embed"): 1})
    per_call_sites("tp qwen2-72b", arms, want)
    done, diffs = {k: arms[k]["done"] for k in ("plain", "mesh")}, arms["diffs"]
    figs = {k: (sum(arms[k]["prefill_ms"]) / len(arms[k]["prefill_ms"]), arms[k]["step_ms"])
            for k in ("plain", "mesh")}
    same_tokens = sum(a == b for i in range(2) for a, b in zip(done["plain"][i],
                                                                done["mesh"][i]))
    log(f"  tp qwen2-72b: prefill logits (equal bit for bit, max |diff|, max |logit|) "
        f"{diffs}; {same_tokens} of {2 * (TP_STEPS + 1)} tokens equal; the (1, 1) mesh adds "
        f"{figs['mesh'][0] - figs['plain'][0]} ms a prefill and "
        f"{figs['mesh'][1] - figs['plain'][1]} ms a decode step (host clock; "
        f"decode {figs['mesh'][1] / figs['plain'][1]} x)")
    if done["plain"] != done["mesh"] or len(diffs) != 2 or any(
            d > 1e-3 * m for _, d, m in diffs):
        raise AssertionError(f"tp qwen2-72b: the (1, 1) mesh differs from the unmeshed "
                             f"engine (logits {diffs}, tokens {done})")
    del params, arms
    torch.cuda.empty_cache()


def tp_a12c_serve(torch, ops, D, mesh, dev, card: str) -> None:
    """(d) deepseek-v3 (MLA + MoE, 4 of 61 layers, full width) with each
    MLA decode path and (e) mamba2-130m (all 24 layers) through ServeEngine
    under the (1, 1) NCCL mesh against the unmeshed engine: prefill logits
    and every token equal bit for bit, the collectives of a prefill and of
    a decode step pinned by site, deepseek-v3's wgmma flash launches at its
    (192, 128) key."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    rng = np.random.default_rng(0)
    runs = [("deepseek-v3-671b", DS_LAYERS, DS_PROMPT, DS_S_MAX, DS_STEPS),
            ("mamba2-130m", 24, TP_MAMBA_PROMPT, TP_MAMBA_PROMPT + TP_MAMBA_STEPS,
             TP_MAMBA_STEPS)]
    for arch, layers, prompt_len, s_max, steps in runs:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers)
        params, init_ms = _timed(torch, lambda: init_params(cfg, seed=0, device=dev))
        n_params = sum(p.numel() for p in params.parameters())
        prompts = [torch.from_numpy(rng.integers(0, cfg.vocab, prompt_len)) for _ in range(2)]
        log(f"tp ({'d' if cfg.attn_type == 'mla' else 'e'}) {arch} [{card}]: full width, "
            f"n_layers {full.n_layers} -> {layers}, {n_params} parameters ({n_params * 2} "
            f"bytes bf16) drawn in {init_ms} ms; two {prompt_len}-token prompts into "
            f"{s_max}, {steps} decode steps, the (1, 1) mesh against unmeshed")
        if cfg.attn_type == "mla":
            per_layer = {("all_gather", "fsdp"): 6, ("all_gather", "mla_q_a"): 1,
                         ("all_gather", "mla_kv_a"): 1, ("all_reduce", "mla_out"): 1}
            want = Counter({k: v * layers for k, v in per_layer.items()})
            # dense FFNs (wi, wg, wo) in the prefix; the MoE layer's weights,
            # aux, combine and shared expert (wi, wg, wo); embed and lm_head
            n_moe = layers - cfg.moe_layer_start
            want.update({("all_gather", "fsdp"): 3 * cfg.moe_layer_start + 3 * n_moe + 2,
                         ("all_reduce", "mlp_out"): cfg.moe_layer_start + n_moe,
                         ("all_gather", "moe_weights"): 4 * n_moe,
                         ("all_reduce", "moe_aux"): n_moe,
                         ("all_reduce", "moe_combine"): n_moe,
                         ("all_reduce", "embed"): 1})
            key = ops.flash_key((1, prompt_len, cfg.n_heads,
                                 cfg.qk_nope_dim + cfg.qk_rope_dim),
                                (1, s_max, cfg.n_heads, 0), True, 0, prompt_len,
                                cfg.v_head_dim)
            variants = (("materialized", False), ("absorbed", True))
        else:
            want = Counter({("all_gather", "ssm_in"): layers,
                            ("all_gather", "ssm_conv"): layers,
                            ("all_reduce", "ssm_norm"): layers,
                            ("all_reduce", "ssm_out"): layers, ("all_reduce", "embed"): 1})
            key, variants = None, (("recurrent", False),)
        for path, absorbed in variants:
            c = dataclasses.replace(cfg, mla_absorbed_decode=absorbed)
            arms = engine_arms(torch, ops, D, mesh, c, params, prompts, s_max, steps)
            what = f"tp {arch} {path} decode"
            for arm in ("plain", "mesh"):
                a = arms[arm]
                at_key = a["pre"][2].get(("flash_attention_wgmma", key), 0) if key else 0
                log(f"  {what} {arm}: each prefill {a['prefill_ms']} ms, decode "
                    f"step_ms={a['step_ms']} decode_tokens_per_s="
                    f"{2 / (a['step_ms'] / 1e3)} ({a['steps']} steps); prefill launches "
                    f"{a['pre'][1]}, at {key}: {at_key}; decode launches {a['dec'][1]}; "
                    f"max_memory_allocated={a['peak']}")
                if key and at_key != layers * a["admitted"]:
                    raise AssertionError(f"{what} {arm}: {at_key} wgmma flash launches at "
                                         f"{key} in {a['admitted']} prefills")
            per_call_sites(what, arms, want)
            same = arms["plain"]["done"] == arms["mesh"]["done"]
            log(f"  {what}: prefill logits (equal bit for bit, max |diff|, max |logit|) "
                f"{arms['diffs']}; tokens equal {same}; the (1, 1) mesh's prefills "
                f"{arms['mesh']['prefill_ms']} against {arms['plain']['prefill_ms']} ms, "
                f"decode {arms['mesh']['step_ms']} against {arms['plain']['step_ms']} ms a "
                f"step ({arms['mesh']['step_ms'] / arms['plain']['step_ms']} x)")
            if not same or len(arms["diffs"]) != 2 or not all(e for e, _, _ in arms["diffs"]):
                raise AssertionError(f"{what}: the (1, 1) mesh differs from the unmeshed "
                                     f"engine ({arms['diffs']}, {arms['plain']['done']} "
                                     f"against {arms['mesh']['done']})")
            del arms
        del params
        torch.cuda.empty_cache()


def _sum_check(torch, what, parts, whole) -> float:
    """The shares' partials summed in rank order (float32) against the
    whole bf16 result: each element within 2^-7 (|whole| + sum |part|),
    four bf16 roundings' room.  Returns max |diff|."""
    total = sum(p.float() for p in parts)
    mag = whole.float().abs() + sum(p.float().abs() for p in parts)
    diff = (total - whole.float()).abs()
    if not bool((diff <= 2.0 ** -7 * mag + 1e-6).all()):
        raise AssertionError(f"tp {what}: the shares' sum is off the whole by up to "
                             f"{float(diff.max())} (bound {2.0 ** -7} x the magnitudes)")
    return float(diff.max())


def tp_shares(torch, ops, dev, card: str) -> None:
    """(b) One qwen2-72b layer at full width over 8192 tokens, whole and as
    the four shares of a (1, 4) mesh (`attention_local` / `mlp_local` on
    `convert.block_views`, 16 heads, 2 kv heads and d_ff 7392 a share),
    summed in rank order against the whole; the vocab-parallel embedding
    and head as four 38016-row shares against the whole (the lookup equal
    bit for bit, the head's argmax tokens equal where the whole's top two
    are apart by more than the shares' difference).  Each share timed by
    CUDA events; the shares' flash launches count as the main path's."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import model as LMM

    cfg = get_config(TP_ARCH)
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(1)
    attn = L.init_attention(g, cfg, dev).requires_grad_(False)
    ffn = L.init_mlp(g, cfg, dev).requires_grad_(False)
    with torch.no_grad():   # zeros at init: drawn, so the bias blocks count
        for b in (attn.bq, attn.bk, attn.bv):
            b.copy_(torch.randn(b.shape, generator=g, device=dev) * 0.02)
    x = torch.randn((1, TP_TOKENS, cfg.d_model), generator=g, device=dev,
                    dtype=torch.bfloat16)
    pos = torch.arange(TP_TOKENS, device=dev)[None]
    log(f"tp (b) one {TP_ARCH} layer [{card}]: {TP_TOKENS} tokens, whole and as {TP_MODEL} "
        f"shares of a (1, {TP_MODEL}) mesh: {cfg.n_heads // TP_MODEL} heads, "
        f"{cfg.n_kv_heads // TP_MODEL} kv heads, d_ff {cfg.d_ff // TP_MODEL} a share")
    out = {}
    for name, whole_fn, share_fn in (
            ("attention", lambda: L.attention_local(attn, x, pos, cfg),
             lambda m: L.attention_local(_share_views(attn, cfg, m), x, pos, cfg, m,
                                         TP_MODEL)),
            ("mlp", lambda: L.mlp_local(ffn, x),
             lambda m: L.mlp_local(_share_views(ffn, cfg, m), x))):
        whole_fn()   # warm-up
        whole, whole_ms = _event_ms(torch, whole_fn)
        share_fn(0)  # warm-up
        ops.reset_launches()
        parts, ms = [], []
        for m in range(TP_MODEL):
            part, t = _event_ms(torch, lambda m=m: share_fn(m))
            parts.append(part)
            ms.append(t)
        MAIN_SHAPES.update(ops.SHAPE_LAUNCHES)
        err = _sum_check(torch, name, parts, whole)
        out[name] = (whole_ms, ms)
        log(f"  tp {name}: whole {whole_ms} ms, shares {ms} ms (CUDA events; sum "
            f"{sum(ms)} ms, {sum(ms) / whole_ms} of the whole), the shares' sum within "
            f"{err} of the whole (max |whole| {float(whole.float().abs().max())}); share "
            f"launches {dict(ops.LAUNCHES)}")
        del parts, whole
    del attn, ffn
    torch.cuda.empty_cache()
    # the vocab-parallel embedding and head
    embed = L.normal_init(g, (cfg.vocab, cfg.d_model), 0.02, torch.bfloat16, dev)
    head = L.dense_init(g, cfg.d_model, cfg.vocab, torch.bfloat16, dev)
    tokens = torch.randint(0, cfg.vocab, (1, TP_TOKENS), generator=g, device=dev)
    rows = cfg.vocab // TP_MODEL
    want = embed[tokens]
    parts = [LMM.embed_rows(embed[m * rows:(m + 1) * rows], tokens, m * rows)
             for m in range(TP_MODEL)]
    got = parts[0]
    for p_ in parts[1:]:
        got = got + p_
    embed_equal = bool(torch.equal(got, want))
    h = x[0, -TP_HEAD_TOKENS:]
    (h @ head).float()   # warm-up
    whole_logits, head_ms = _event_ms(torch, lambda: (h @ head).float())
    shares, head_share_ms = [], []
    for m in range(TP_MODEL):
        block = head[:, m * rows:(m + 1) * rows].contiguous()
        if m == 0:
            (h @ block).float()   # warm-up: the share's product shape
        lg, t = _event_ms(torch, lambda b=block: (h @ b).float())
        shares.append(lg)
        head_share_ms.append(t)
    sharded = torch.cat(shares, dim=-1)
    gap = float((sharded - whole_logits).abs().max())
    top2 = torch.topk(whole_logits, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > gap
    same = torch.argmax(sharded, -1) == torch.argmax(whole_logits, -1)
    log(f"  tp embedding: {TP_MODEL} shares of {rows} rows summed equal to the whole lookup "
        f"bit for bit {embed_equal}; head over {TP_HEAD_TOKENS} tokens: whole {head_ms} ms, "
        f"shares {head_share_ms} ms (CUDA events), logits equal bit for bit "
        f"{bool(torch.equal(sharded, whole_logits))} (max |diff| {gap}), argmax equal "
        f"{int(same.sum())} of {TP_HEAD_TOKENS} ({int(clear.sum())} with a top-2 gap above "
        f"the diff, all of them equal {bool(same[clear].all())}); peak memory "
        f"{torch.cuda.max_memory_allocated()}")
    if not embed_equal or not bool(same[clear].all()):
        raise AssertionError("tp embedding / head: the shares differ from the whole")
    del embed, head, want, parts, got, whole_logits, shares, sharded
    torch.cuda.empty_cache()


def tp_train(torch, ops, D, mesh, dev, card: str) -> None:
    """(c) qwen1.5-0.5b trained at full width over 8192 tokens, batch 1,
    through TrainStep under the (1, 1) NCCL mesh against the same steps
    with no mesh: loss trajectories within TP_TRAIN_RTOL relative, the
    collectives of a step, the step times."""
    import contextlib

    from repro_torch import convert
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.sharding.ctx import mesh_context
    from repro_torch.train import OptConfig, init_train_state, make_train_step
    from repro_torch.train.data import SyntheticDataset, to_device

    cfg = get_config(TRAIN_ARCH)
    data = SyntheticDataset(cfg, ShapeSpec("train", TRAIN_SEQ, 1, "train"))
    losses, step_ms, sites = {}, {}, {}
    for arm in ("plain", "mesh"):
        model, opt_state = init_train_state(cfg, seed=0, device=dev)
        n_params = sum(1 for _ in model.parameters())
        if arm == "mesh":
            convert.shard_module(model, cfg, mesh)
        step = make_train_step(cfg, OptConfig(name=cfg.optimizer))
        ctx = mesh_context(mesh, ("data",)) if arm == "mesh" else contextlib.nullcontext()
        losses[arm], step_ms[arm] = [], []
        torch.cuda.reset_peak_memory_stats()
        with ctx:
            for i in range(TP_TRAIN_STEPS):
                batch = to_device(data.batch(i), cfg, dev)
                ops.reset_launches()
                D.reset_collectives()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, opt_state, m = step(model, opt_state, batch, i)
                losses[arm].append(float(m.loss))
                torch.cuda.synchronize()
                step_ms[arm].append((time.perf_counter() - t0) * 1e3)
                if arm == "mesh":
                    MAIN_SHAPES.update(ops.SHAPE_LAUNCHES)
                    sites = dict(D.COLLECTIVE_SITES)
        log(f"  tp train {TRAIN_ARCH} {arm} [{card}]: losses={losses[arm]} step_ms="
            f"{step_ms[arm]} peak_memory_bytes={torch.cuda.max_memory_allocated()} flash "
            f"launches the last step={dict(ops.LAUNCHES)}")
        del model, opt_state, step
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["mesh"], losses["plain"]))
    med = {k: sorted(v[1:])[len(v[1:]) // 2] for k, v in step_ms.items()}
    log(f"  tp train: the (1, 1) mesh's losses within {rel} of the plain run's (relative); "
        f"collectives a step {sites}; median step_ms (steps 2 on) plain {med['plain']} mesh "
        f"{med['mesh']} ({med['mesh'] / med['plain']} x)")
    if not rel <= TP_TRAIN_RTOL:
        raise AssertionError(f"tp train: losses {losses}")
    # at model 1 the attention's weights are whole (no replicated input);
    # the FFN's wo splits over the one-rank `model` axis by its spec; one
    # gradient all-reduce over `data` a parameter
    if (sites.get(("all_reduce", "mlp_in.grad")) != cfg.n_layers
            or sites.get(("all_reduce", "grad_sync")) != n_params):
        raise AssertionError(f"tp train: collectives {sites}")


def _share_views(module, cfg, m: int):
    """The (1, TP_MODEL) mesh's rank m's blocks of a whole module (views)."""
    from types import SimpleNamespace

    from repro_torch import convert

    blocks = convert.block_views(module, cfg, {"data": 1, "model": TP_MODEL},
                                 {"data": 0, "model": m})
    return SimpleNamespace(**{n: t for n, (t, _) in blocks.items()})


def _staged_shares(torch, stages, n: int):
    """Run `stages` (each fn(m, previous stage's result) -> share m's
    output, then a combine(outputs) -> the next stage's input, the
    collective done by hand in rank order) over the n shares; returns (the
    last combine's result, each share's summed CUDA-event ms, the last
    stage's outputs)."""
    ms, prev, outs = [0.0] * n, None, None
    for fn, combine in stages:
        outs = []
        for m in range(n):
            o, t = _event_ms(torch, lambda m=m: fn(m, prev))
            outs.append(o)
            ms[m] += t
        prev = combine(outs)
    return prev, ms, outs


def tp_a12c_shares(torch, ops, dev, card: str) -> None:
    """(f) One deepseek-v3 MLA layer and one jamba-1.5-large Mamba2 layer at
    full width over TP_TOKENS tokens, whole and as the four shares of a
    (1, 4) mesh on `convert.block_views` (MLA: the latents' column blocks,
    gathered by hand, then `mla_local` on 32 heads a share; Mamba2: in_proj's
    and the conv's blocks gathered, the SSD on 64 of 256 heads, the norm's
    sums of squares summed, out_proj's rows), the partials summed in rank
    order against the whole; each share timed (CUDA events); the MLA shares'
    flash launches count as the main path's."""
    from repro_torch.configs import get_config
    from repro_torch.models import mla as MLA
    from repro_torch.models import ssm as SSM

    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(2)
    pos = torch.arange(TP_TOKENS, device=dev)[None]
    cfg = get_config("deepseek-v3-671b")
    mla = MLA.init_mla(g, cfg, dev).requires_grad_(False)
    x = torch.randn((1, TP_TOKENS, cfg.d_model), generator=g, device=dev,
                    dtype=torch.bfloat16)

    def mla_whole():
        return MLA.mla_local(mla, x, *MLA.mla_latents(mla, x), pos, cfg)

    mla_whole()   # warm-up
    whole, whole_ms = _event_ms(torch, mla_whole)
    views = [_share_views(mla, cfg, m) for m in range(TP_MODEL)]
    MLA.mla_latents(views[0], x)   # warm-up: the shares' product shapes
    stage1 = (lambda m, _: MLA.mla_latents(views[m], x),
              lambda outs: [torch.cat(parts, dim=-1) for parts in zip(*outs)])
    (q_lat, kv_lat), lat_ms, _ = _staged_shares(torch, [stage1], TP_MODEL)
    MLA.mla_local(views[0], x, q_lat, kv_lat, pos, cfg, 0, TP_MODEL)   # warm-up
    ops.reset_launches()
    stage2 = (lambda m, _: MLA.mla_local(views[m], x, q_lat, kv_lat, pos, cfg, m, TP_MODEL),
              lambda outs: None)
    _, head_ms, parts = _staged_shares(torch, [stage2], TP_MODEL)
    MAIN_SHAPES.update(ops.SHAPE_LAUNCHES)
    hd = cfg.n_heads // TP_MODEL
    key = ops.flash_key((1, TP_TOKENS, hd, cfg.qk_nope_dim + cfg.qk_rope_dim),
                        (1, TP_TOKENS, hd, 0), True, 0, TP_TOKENS, cfg.v_head_dim)
    at_key = ops.SHAPE_LAUNCHES[("flash_attention_wgmma", key)]
    err = _sum_check(torch, "MLA", parts, whole)
    ms = [a + b for a, b in zip(lat_ms, head_ms)]
    log(f"tp (f) one deepseek-v3 MLA layer [{card}]: {TP_TOKENS} tokens, whole {whole_ms} ms; "
        f"{TP_MODEL} shares of {hd} heads {ms} ms (latent blocks {lat_ms}, heads {head_ms}; "
        f"CUDA events; sum {sum(ms)} ms, {sum(ms) / whole_ms} of the whole), the shares' sum "
        f"within {err} of the whole (max |whole| {float(whole.float().abs().max())}); "
        f"wgmma flash launches at {key}: {at_key}; share launches {dict(ops.LAUNCHES)}")
    if at_key != TP_MODEL:
        raise AssertionError(f"tp MLA shares: {at_key} wgmma flash launches at {key}, "
                             f"expected {TP_MODEL}")
    del mla, views, whole, parts, q_lat, kv_lat, x
    torch.cuda.empty_cache()

    cfg = get_config("jamba-1.5-large-398b")
    mb = SSM.init_mamba(g, cfg, dev).requires_grad_(False)
    n_bytes = sum(p.numel() * p.element_size() for p in mb.parameters())
    x = torch.randn((1, TP_TOKENS, cfg.d_model), generator=g, device=dev,
                    dtype=torch.bfloat16)
    SSM.mamba_mixer(mb, x, cfg)   # warm-up
    whole, whole_ms = _event_ms(torch, lambda: SSM.mamba_mixer(mb, x, cfg))
    views = [_share_views(mb, cfg, m) for m in range(TP_MODEL)]

    def cat(outs):
        return torch.cat(outs, dim=-1)

    def mamba_shares():
        state = {}

        def heads(m, conv):
            return SSM.ssm_heads(views[m], state["proj"], conv, cfg, m)

        def keep_proj(outs):
            state["proj"] = cat(outs)
            return state["proj"]

        def norm(outs):
            state["g"] = [o[0] for o in outs]
            total = outs[0][1]
            for o in outs[1:]:
                total = total + o[1]
            return total

        return _staged_shares(torch, [
            (lambda m, _: x @ views[m].in_proj, keep_proj),
            (lambda m, proj: SSM.ssm_conv(views[m], proj, cfg, m), cat),
            (heads, norm),
            (lambda m, ssq: SSM.ssm_out(views[m], state["g"][m], ssq, cfg, m),
             lambda outs: None)], TP_MODEL)

    mamba_shares()   # warm-up
    _, ms, parts = mamba_shares()
    err = _sum_check(torch, "Mamba2", parts, whole)
    log(f"tp (f) one jamba-1.5-large Mamba2 layer [{card}]: d_inner {cfg.d_inner}, "
        f"{cfg.ssm_heads} heads, d_state {cfg.d_state}, {n_bytes} bytes of bf16 weights, "
        f"{TP_TOKENS} tokens: whole {whole_ms} ms; {TP_MODEL} shares of "
        f"{cfg.ssm_heads // TP_MODEL} heads {ms} ms (CUDA events; sum {sum(ms)} ms, "
        f"{sum(ms) / whole_ms} of the whole), the shares' sum within {err} of the whole "
        f"(max |whole| {float(whole.float().abs().max())}); peak memory "
        f"{torch.cuda.max_memory_allocated()}")
    del mb, views, whole, parts, x
    torch.cuda.empty_cache()


def tp_a12c_train(torch, ops, D, mesh, dev, card: str) -> None:
    """(g) SMOKE deepseek-v3 (MLA + MoE + MTP, Adafactor) and SMOKE jamba
    (Mamba2, attention, MoE), float32, one TrainStep each on the (1, 1)
    mesh against the same step with no mesh (twice: the card's own spread
    between two identical steps): the losses, and every leaf's gradient
    (`TrainStep.grads`, before clipping) against its largest."""
    import contextlib

    from repro_torch import convert
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.sharding.ctx import mesh_context
    from repro_torch.train import OptConfig, init_train_state, make_train_step
    from repro_torch.train.data import SyntheticDataset, to_device

    for arch in ("deepseek-v3-671b", "jamba-1.5-large-398b"):
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        batch = to_device(SyntheticDataset(cfg, ShapeSpec("train", TP_SMOKE_SEQ, 2, "train"))
                          .batch(0), cfg, dev)
        losses, grads, sites = {}, {}, {}
        for arm in ("plain", "plain again", "mesh"):
            model, opt_state = init_train_state(cfg, seed=0, device=dev)
            if arm == "mesh":
                convert.shard_module(model, cfg, mesh)
            step = make_train_step(cfg, OptConfig(name=cfg.optimizer))
            ctx = mesh_context(mesh, ("data",)) if arm == "mesh" else contextlib.nullcontext()
            with ctx:
                D.reset_collectives()
                _, _, m = step(model, opt_state, batch, 0)
                sites[arm] = {k: v for k, v in D.COLLECTIVE_SITES.items()
                              if k[1].split(".")[0] in ("mla_in", "mla_q_a", "mla_kv_a",
                                                        "mla_out", "mtp_proj", "mtp_in",
                                                        "ssm_in", "ssm_conv", "ssm_norm",
                                                        "ssm_out", "ssm_mark")}
            losses[arm] = float(m.loss)
            grads[arm] = {n: t.detach().clone() for n, t in step.grads.items()}
            del model, opt_state, step

        def spread(a, b):
            """(leaves equal bit for bit, the largest |a - b| / max |b| of a leaf)."""
            same = sum(bool(torch.equal(a[n], b[n])) for n in b)
            rel = max(float((a[n] - b[n]).abs().max() / b[n].abs().max().clamp_min(1e-30))
                      for n in b)
            return same, rel

        repeat, mesh_vs = spread(grads["plain again"], grads["plain"]), spread(
            grads["mesh"], grads["plain"])
        log(f"tp (g) SMOKE {arch} trained a step [{card}]: losses plain "
            f"{losses['plain']} / {losses['plain again']}, (1, 1) mesh {losses['mesh']}; "
            f"gradients (leaves equal bit for bit of {len(grads['plain'])}, largest relative "
            f"difference of a leaf): plain again {repeat}, mesh {mesh_vs}; the mesh step's "
            f"layout collectives {sites['mesh']}")
        if (abs(losses["mesh"] - losses["plain"]) > TP_TRAIN_RTOL * abs(losses["plain"])
                or mesh_vs[1] > max(1e-5, 10 * repeat[1]) or not sites["mesh"]):
            raise AssertionError(f"tp (g) {arch}: the (1, 1) mesh's step differs from the "
                                 f"unmeshed one (losses {losses}, gradients {mesh_vs}, "
                                 f"repeat {repeat}, sites {sites['mesh']})")
        torch.cuda.empty_cache()


def tp_phase(torch, ops, dev, card: str) -> None:
    """The specs' layout: (a) qwen2-72b served through the (1, 1) NCCL mesh,
    (b) one full-width qwen2-72b layer, its embedding and head as (1, 4)
    shares, (c) qwen1.5-0.5b trained on the (1, 1) mesh, (d) deepseek-v3
    and (e) mamba2 served through the (1, 1) mesh, (f) one deepseek-v3 MLA
    layer and one jamba Mamba2 layer as (1, 4) shares, (g) SMOKE
    deepseek-v3 and jamba trained a step on the (1, 1) mesh."""
    from repro_torch.core import distributed as D

    t0 = time.perf_counter()
    mesh, store = nccl_world(torch)
    try:
        tp_serve(torch, ops, D, mesh, dev, card)
        t1 = time.perf_counter()
        log(f"tp: (a) {t1 - t0} s")
        tp_train(torch, ops, D, mesh, dev, card)
        t2 = time.perf_counter()
        log(f"tp: (c) {t2 - t1} s")
        tp_a12c_serve(torch, ops, D, mesh, dev, card)
        t1 = time.perf_counter()
        log(f"tp: (d) and (e) {t1 - t2} s")
        tp_a12c_train(torch, ops, D, mesh, dev, card)
        log(f"tp: (g) {time.perf_counter() - t1} s")
    finally:
        leave_world(store)
    t1 = time.perf_counter()
    tp_shares(torch, ops, dev, card)
    t2 = time.perf_counter()
    log(f"tp: (b) {t2 - t1} s")
    tp_a12c_shares(torch, ops, dev, card)
    log(f"tp: (f) {time.perf_counter() - t2} s; phase {time.perf_counter() - t0} s")


# the cost phase: the dry-run's production cells run by its command line
# (arch, shape, mesh, variant), and the prefill counted on the card
COST_CELLS = [("qwen2-72b", "prefill_32k", "single", "baseline"),
              ("deepseek-v3-671b", "train_4k", "single", "opt"),
              ("mixtral-8x22b", "decode_32k", "multi", "baseline"),
              ("acai-retrieval", None, "single", "baseline")]
COST_ARCH, COST_SEQ = "qwen1.5-0.5b", 8192
COST_PEAK_RTOL, COST_PROFILER_RTOL = 0.10, 0.01
COST_CHILD_TIMEOUT_S = 600
# the matmul family as torch.profiler names it (the ops the cost mode
# counts as dots)
PROFILER_DOTS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::addbmm",
                 "aten::mv", "aten::addmv", "aten::dot")
# the meta count of the card's prefill: rank 0 of a one-rank fake world
_COST_META_CHILD = """
import json, sys
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
arch, seq = sys.argv[1], int(sys.argv[2])
with dryrun.world_less_mesh(False, smoke=True) as mesh:
    run, args, info = dryrun.build_lowering(
        get_config(arch), ShapeSpec("prefill", seq, 1, "prefill"), mesh, False)
    rec = dryrun.analyse(run, args, info, 1)
print(json.dumps(rec))
"""


# the long phase (ROADMAP C14, C15): long_500k's decode at global batch 1 on
# the single-pod mesh, whose LONG_SHARES `data` ranks each hold 1/16 of the
# sequence, run as those shares one after another on the card (NCCL refuses
# two ranks on one card); jamba-1.5-large's attention layer over its 524288
# slots, mixtral-8x22b's 4096-slot ring one step past the window, mixtral's
# MoE layer over LONG_MOE_TOKENS tokens as 16 data shares; the dry-run's
# long_500k jamba cells
LONG_SLOTS, LONG_SHARES, LONG_RING_PAST, LONG_MOE_TOKENS = 524288, 16, 1000, 8192
LONG_F32_TOL = 1e-5     # float32 attention against float64, over the largest |v|
LONG_BF16_TOL = 2e-2    # bf16 outputs against the whole's, over its largest |.|
LONG_ARCH = "jamba-1.5-large-398b"


def _long_dryrun_child(out_dir):
    """The dry-run's long_500k cells of LONG_ARCH on both production meshes,
    by its command line in a process of the card's host (no card)."""
    import os

    env = {**os.environ, "PYTHONPATH": str(SRC), "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", LONG_ARCH, "--shape",
         "long_500k", "--mesh", "both", "--out", str(out_dir), "--force"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _softmax64(torch, q, k, v):
    """One softmax over every slot in float64 (every slot kept): q (1, 1, H,
    D), k / v (1, T, KV, D), GQA head h on kv head h // (H / KV) -> (1, 1,
    H, D)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.double().reshape(b, s, kv, h // kv, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.double()) / d ** 0.5
    out = torch.einsum("bkgst,btkd->bskgd", torch.softmax(logits, dim=-1), v.double())
    return out.reshape(b, s, h, d)


def _plain_f32(torch, q, k, v):
    """The unmeshed decode's float32 attention before its cast (`_sdpa`'s
    arithmetic, every slot kept)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.float().reshape(b, s, kv, h // kv, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / d ** 0.5
    out = torch.einsum("bkgst,btkd->bskgd", torch.softmax(logits, dim=-1), v.float())
    return out.reshape(b, s, h, d)


def _seq_shares(torch, L, p, x, pos, cfg, cache, cache_len: int, n: int):
    """`attention_local` as the n ranks of a sequence-sharded cache, one
    after another: rank r on its slots [r T, (r + 1) T) (views of `cache`),
    its exchange recording its softmax partials (the all-gather's input);
    then the rank-order combine of all of them (`combine_partials`, what
    every rank runs on the gathered partials), cast and times wo.  Returns
    (the combined float32 attention, the layer's output, each rank's ms,
    the combine's ms; CUDA events)."""
    from repro_torch.sharding.tp import SeqShard

    whole = cache["k"].shape[1]
    t = whole // n
    parts, ms = [], []

    def record(part):
        parts.append(part)
        return part[None]

    for r in range(n):
        share = {name: leaf[:, r * t:(r + 1) * t] for name, leaf in cache.items()}
        _, m = _event_ms(torch, lambda: L.attention_local(
            p, x, pos, cfg, cache=share, cache_len=cache_len,
            seq=SeqShard(r * t, whole, record)))
        ms.append(m)
    comb, comb_ms = _event_ms(torch, lambda: L.combine_partials(torch.stack(parts)))
    out = comb.to(x.dtype).reshape(x.shape[0], x.shape[1], -1) @ p.wo
    return comb, out, ms, comb_ms


def _long_attention(torch, dev, card: str, arch: str, slots: int, cache_len: int,
                    what: str) -> None:
    """One decode step of `arch`'s attention layer at its published widths
    (bf16, weights and a `slots`-slot cache drawn from a seed, every slot
    kept at `cache_len`), whole (the unmeshed decode) and as LONG_SHARES
    sequence shares: the shares' float32 attention and the whole's against
    float64, the layers' bf16 outputs against each other."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    cfg = get_config(arch)
    g = torch.Generator(device=dev).manual_seed(4)
    p = L.init_attention(g, cfg, dev).requires_grad_(False)
    shape = (1, slots, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16),
             "v": torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)}
    x = torch.randn((1, 1, cfg.d_model), generator=g, device=dev, dtype=torch.bfloat16)
    pos = torch.full((1, 1), cache_len, device=dev)

    def whole():
        return L.attention_local(p, x, pos, cfg, cache=cache, cache_len=cache_len)

    whole()   # warm-up (the step rewrites its own slot with the same k / v)
    want, whole_ms = _event_ms(torch, whole)
    _seq_shares(torch, L, p, x, pos, cfg, cache, cache_len, LONG_SHARES)   # warm-up
    comb, got, ms, comb_ms = _seq_shares(torch, L, p, x, pos, cfg, cache, cache_len,
                                         LONG_SHARES)
    q = (x @ p.wq).reshape(1, 1, cfg.n_heads, cfg.head_dim)
    if cfg.pos_emb == "rope":
        q = L.apply_rope(q, pos, cfg.rope_theta)
    ref = _softmax64(torch, q, cache["k"], cache["v"])
    plain = _plain_f32(torch, q, cache["k"], cache["v"])
    scale = float(cache["v"].float().abs().max())
    err = float((comb.double() - ref).abs().max()) / scale
    err_plain = float((plain.double() - ref).abs().max()) / scale
    err_out = float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())
    kv_bytes = 2 * cache["k"].numel() * cache["k"].element_size()
    log(f"long {what} [{card}]: d {cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} kv, "
        f"head dim {cfg.head_dim}, bf16, one decode step at position {cache_len} over "
        f"{slots} slots: whole {whole_ms} ms; {LONG_SHARES} shares of {slots // LONG_SHARES} "
        f"slots {ms} ms (sum {sum(ms)}), combine {comb_ms} ms (CUDA events); k + v bytes "
        f"{kv_bytes} whole, {kv_bytes // LONG_SHARES} a share; float32 attention against "
        f"float64, over max |v| {scale}: shares combined {err}, the whole's plain {err_plain}; "
        f"the layer's bf16 output against the whole's {err_out} (over its max)")
    if not (err <= LONG_F32_TOL and err_out <= LONG_BF16_TOL):
        raise AssertionError(f"long {what}: the shares' attention is {err} from float64 "
                             f"(tolerance {LONG_F32_TOL}), their layer output {err_out} from "
                             f"the whole's ({LONG_BF16_TOL})")
    del p, cache, ref, plain
    torch.cuda.empty_cache()


def _long_moe(torch, dev, card: str) -> None:
    """(c) mixtral-8x22b's MoE layer at its published widths over
    LONG_MOE_TOKENS tokens, whole (the unmeshed single-stage layer) and as
    LONG_SHARES data shares with whole experts: each routes its tokens, the
    expert ids stacked in rank order (the gather by hand), then `moe_share`
    on its own rows; the outputs concatenated against the whole."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M

    cfg = dataclasses.replace(get_config("mixtral-8x22b"), moe_dp=0)
    g = torch.Generator(device=dev).manual_seed(5)
    layer, init_ms = _timed(torch, lambda: M.init_moe(g, cfg, dev).requires_grad_(False))
    expert_bytes = sum(t.numel() * t.element_size() for t in (layer.wi, layer.wg, layer.wo))
    x = torch.randn((1, LONG_MOE_TOKENS, cfg.d_model), generator=g, device=dev,
                    dtype=torch.bfloat16)
    M.moe_ffn(layer, x, cfg)   # warm-up
    (want, _), whole_ms = _event_ms(torch, lambda: M.moe_ffn(layer, x, cfg))
    xf = x.reshape(-1, cfg.d_model)
    tl = LONG_MOE_TOKENS // LONG_SHARES
    rows = []
    ffn = M.expert_ffn

    def probe(wi, wg, wo, buf):
        rows.append(buf.shape[1])
        return ffn(wi, wg, wo, buf)

    def shares():
        routed = [M.route(layer, xf[r * tl:(r + 1) * tl], cfg) for r in range(LONG_SHARES)]
        ids = torch.stack([e for _, _, e in routed])
        outs, ms = [], []
        for r, (_, gate, eidx) in enumerate(routed):
            o, m = _event_ms(torch, lambda: M.moe_share(
                xf[r * tl:(r + 1) * tl], gate, eidx, ids, r, layer.wi, layer.wg, layer.wo, 0,
                cfg))
            outs.append(o)
            ms.append(m)
        return torch.cat(outs), ms

    M.expert_ffn = probe
    try:
        shares()   # warm-up
        rows.clear()
        got, ms = shares()
    finally:
        M.expert_ffn = ffn
    cap = M.capacity(LONG_MOE_TOKENS, cfg)
    err = float((got.float() - want.reshape(got.shape).float()).abs().max()) / float(
        want.float().abs().max())
    log(f"long (c) mixtral-8x22b MoE layer [{card}]: {cfg.n_experts} experts x 3 x "
        f"{cfg.d_model} x {cfg.moe_d_ff} ({expert_bytes} bytes bf16, drawn in {init_ms} ms), "
        f"{LONG_MOE_TOKENS} tokens, capacity {cap}: whole (single-stage, {cfg.n_experts} x "
        f"{cap} rows) {whole_ms} ms; {LONG_SHARES} shares of {tl} tokens, rows an expert "
        f"{rows} ({cfg.n_experts} x {rows[0] if rows else 0} a share; {cfg.n_experts} x {cap} "
        f"before C15), {ms} ms (sum {sum(ms)}; CUDA events, the routing outside); the "
        f"concatenated outputs against the whole's {err} (over its max |.|)")
    if rows != [min(tl, cap)] * LONG_SHARES or not err <= LONG_BF16_TOL:
        raise AssertionError(f"long (c): rows {rows}, expected {min(tl, cap)} a share; "
                             f"outputs {err} from the whole's (tolerance {LONG_BF16_TOL})")
    del layer, x, xf, want, got
    torch.cuda.empty_cache()


def long_phase(torch, dev, card: str) -> None:
    """(a) jamba's attention layer at long_500k as the single-pod mesh's 16
    sequence shares, (b) mixtral's ring past the window, (c) mixtral's MoE
    layer as 16 data shares on their own rows, (d) the dry-run's long_500k
    jamba cells: `argument_bytes` = parameters + the rank's cache + batch
    (the module's docstring, phase 15)."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_long_")
    child = _long_dryrun_child(out_dir)
    try:
        torch.cuda.reset_peak_memory_stats()
        _long_attention(torch, dev, card, LONG_ARCH, LONG_SLOTS, LONG_SLOTS - 1,
                        f"(a) {LONG_ARCH} attention layer, long_500k")
        window = get_config("mixtral-8x22b").sliding_window
        _long_attention(torch, dev, card, "mixtral-8x22b", window, window + LONG_RING_PAST,
                        "(b) mixtral-8x22b ring")
        _long_moe(torch, dev, card)
        log(f"long: peak memory {torch.cuda.max_memory_allocated()}")
        out = _finish(child, f"the dry-run of {LONG_ARCH} long_500k")
        for mesh_kind in ("single", "multi"):
            with open(f"{out_dir}/{LONG_ARCH}__long_500k__{mesh_kind}.json") as f:
                r = json.load(f)
            if r["status"] != "ok":
                raise AssertionError(f"long (d): {mesh_kind}: {r['status']} {r.get('error')}"
                                     f"\n{out}")
            h, mem = r["hlo"], r["live_memory"]
            want = r["params_bytes_per_device"] + r["cache_bytes_per_device"] + 4
            log(f"long (d) {LONG_ARCH} long_500k {mesh_kind}: argument_bytes "
                f"{mem['argument_bytes']} = params {r['params_bytes_per_device']} + cache "
                f"{r['cache_bytes_per_device']} + 4 (the token) {mem['argument_bytes'] == want}"
                f"; peak_bytes {mem['peak_bytes']} flops_per_device {h['flops_per_device']} "
                f"hbm_bytes_per_device {h['hbm_bytes_per_device']} calls "
                f"{h['collective_counts']} run_seconds {r['run_seconds']}")
            if mem["argument_bytes"] != want:
                raise AssertionError(f"long (d): {mesh_kind} argument_bytes "
                                     f"{mem['argument_bytes']} != {want}")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    log(f"long: phase {time.perf_counter() - t0} s")


def _cost_children(out_dir):
    """Start the phase's CPU processes (no card: CUDA_VISIBLE_DEVICES
    empty): the dry-run's command line on each COST_CELLS cell, and the
    meta count of the card's prefill.  Returns {name: process}."""
    import os

    env = {**os.environ, "PYTHONPATH": str(SRC), "CUDA_VISIBLE_DEVICES": ""}
    procs = {}
    for arch, shape, mesh_kind, variant in COST_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--mesh", mesh_kind, "--variant", variant, "--out", str(out_dir), "--force"]
        if shape:
            cmd += ["--shape", shape]
        procs[(arch, shape, mesh_kind)] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    procs["meta"] = subprocess.Popen(
        [sys.executable, "-c", _COST_META_CHILD, COST_ARCH, str(COST_SEQ)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    return procs


def _finish(proc, what: str) -> str:
    out, err = proc.communicate(timeout=COST_CHILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"cost: {what} exited {proc.returncode}:\n{err[-3000:]}")
    return out


def cost_phase(torch, ops, dev, card: str) -> None:
    """(a) the dry-run's production cells by its command line, (b) the
    card's count of a full-width prefill against its meta count and
    torch.profiler, (c) its FLOPs over its time (the module's docstring,
    phase 16)."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.core import distributed as D
    from repro_torch.launch import dryrun
    from repro_torch.launch.cost import COLLECTIVES, CostMode
    from repro_torch.launch.mesh import fake_backend_source

    import shutil
    import tempfile

    t0 = time.perf_counter()
    log(f"cost: the fake backend of the world-less meshes: {fake_backend_source()}")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    procs = _cost_children(out_dir)
    try:
        cfg = get_config(COST_ARCH)
        mesh, store = nccl_world(torch)
        try:
            run, args, info = dryrun.build_lowering(
                cfg, ShapeSpec("prefill", COST_SEQ, 1, "prefill"), mesh, False)
            torch.cuda.synchronize()
            # (c) the prefill's time first: no profiler has run in this phase
            ms = time_ms(torch, run, 3, warmup=1)
            ops.reset_launches()
            D.reset_collectives()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with CostMode(args) as mode:
                run()
            torch.cuda.synchronize()
            rise = torch.cuda.max_memory_allocated() - base
            launches = {k: n for k, n in ops.LAUNCHES.items() if n}
            MAIN_SHAPES.update(ops.SHAPE_LAUNCHES)
            card_sum = mode.summary
            prof_kw = dict(activities=[torch.profiler.ProfilerActivity.CPU,
                                       torch.profiler.ProfilerActivity.CUDA],
                           with_flops=True)
            with torch.profiler.profile(**prof_kw) as prof:
                run()
                torch.cuda.synchronize()
            by_op = {e.key: e.flops for e in prof.key_averages() if e.key in PROFILER_DOTS}
            del run, args
        finally:
            leave_world(store)
        torch.cuda.empty_cache()
        meta = json.loads(_finish(procs.pop("meta"), "the meta count").strip().splitlines()[-1])
        mh = meta["hlo"]
        rec = card_sum.record()
        log(f"cost (b) {COST_ARCH} prefill of {COST_SEQ} tokens on the (1, 1) NCCL mesh "
            f"[{card}]: flops={card_sum.flops} (aten dots {card_sum.aten_flops}, kernels "
            f"{rec['counted_ops']['kernels']}), hbm_bytes={card_sum.bytes}, collective "
            f"bytes {card_sum.coll_bytes}, calls {card_sum.coll_counts}, launches {launches}; "
            f"meta: flops={mh['flops_per_device']}, hbm_bytes={mh['hbm_bytes_per_device']}, "
            f"bytes {mh['collective_bytes_per_shard']}, calls {mh['collective_counts']}, "
            f"kernels {meta['counted_ops']['kernels']}")
        if card_sum.flops != mh["flops_per_device"]:
            raise AssertionError(f"cost (b): card flops {card_sum.flops} != meta "
                                 f"{mh['flops_per_device']}")
        if (card_sum.coll_counts != mh["collective_counts"]
                or card_sum.coll_bytes != mh["collective_bytes_per_shard"]):
            raise AssertionError("cost (b): the card's collectives differ from the meta count")
        meta_launches = {k: v["launches"] for k, v in meta["counted_ops"]["kernels"].items()}
        if launches != meta_launches or launches.get("flash_attention_wgmma") != cfg.n_layers:
            raise AssertionError(f"cost (b): launches {launches}, meta {meta_launches}, "
                                 f"expected one wgmma flash launch a layer")
        prof_flops = float(sum(by_op.values()))
        rel = abs(card_sum.aten_flops - prof_flops) / prof_flops
        log(f"cost (b) torch.profiler (with_flops) over the matmul family: {prof_flops} "
            f"({by_op}); the cost mode's {card_sum.aten_flops}: relative difference {rel}")
        if not rel <= COST_PROFILER_RTOL:
            raise AssertionError(f"cost (b): matmul flops {card_sum.aten_flops} against the "
                                 f"profiler's {prof_flops}: {rel} > {COST_PROFILER_RTOL}")
        peak = card_sum.temp_peak_bytes
        rel = abs(peak - rise) / rise
        log(f"cost (b) peak of live bytes {peak} (meta {meta['live_memory']['temp_peak_bytes']})"
            f" against the rise of max_memory_allocated {rise}: relative difference {rel}")
        if not rel <= COST_PEAK_RTOL:
            raise AssertionError(f"cost (b): peak {peak} against the allocator's {rise}: "
                                 f"{rel} > {COST_PEAK_RTOL}")
        log(f"cost (c) {COST_ARCH} prefill of {COST_SEQ} tokens [{card}]: {ms} ms (CUDA "
            f"events, 3 calls after 1), {card_sum.flops / ms / 1e9} TFLOP/s counted")

        for (arch, shape, mesh_kind), proc in procs.items():
            out = _finish(proc, f"the dry-run of {arch} {shape or ''} {mesh_kind}")
            shape = shape or dryrun.ACAI_SHAPE
            with open(dryrun.cell_path(out_dir, arch, shape, mesh_kind)) as f:
                r = json.load(f)
            if r["status"] != "ok":
                raise AssertionError(f"cost (a): {arch} {shape} {mesh_kind}: {r['status']} "
                                     f"{r.get('error')}\n{out}")
            h = r["hlo"]
            log(f"cost (a) {arch} {shape} {mesh_kind} {r['variant']}: flops_per_device="
                f"{h['flops_per_device']} hbm_bytes_per_device={h['hbm_bytes_per_device']} "
                f"collective_bytes_per_shard="
                f"{ {c: h['collective_bytes_per_shard'][c] for c in COLLECTIVES} } "
                f"calls {h['collective_counts']} peak_bytes={r['live_memory']['peak_bytes']} "
                f"run_seconds={r['run_seconds']} total_seconds={r['total_seconds']}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    log(f"cost: phase {time.perf_counter() - t0} s")


def flash_phase(torch, ops, ref, dev):
    """flash_attention against its plain version, f32 (the FMA kernel) and
    bf16 (the wgmma kernel), with FLASH_BF16's shapes timed in the log (the
    JSON rows come by shape, in shapes_phase)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import cost as W

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

        pairs = W.kept_pairs(b, s, t, causal, window, q_off, wu)
        work = W.flash_attention(b, s, t, h, kv, d, d, causal=causal, window=window,
                                 q_offset=q_off, written_upto=wu)
        nbytes = work.bytes
        bms, by = W.bound_ms(work)
        t_k = time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw), 20)
        t_p = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw), 3, 1)
        wuu = t if wu is None else wu
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream

        def run_fma():  # the float32 FMA kernel this shape ran on before
            rc = fma(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t,
                     h, kv, d, d, int(causal), window, q_off, wuu, 1.0 / d ** 0.5, 1, stream)
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
TOPK_PLAN_DK = [(d, k) for d in (128, 1024, 2048, 4096, 8192)
                for k in (16, 51, 64, 160, 400, 1024)]
# l2_topk beyond the retrieval slice's width: the semantic tier's catalog at
# qwen1.5-0.5b's d_model, and yi-6b's (16 GB of float32 catalog)
TOPK_WIDE = [(64, 1_000_000, 1024, 16), (64, 1_000_000, 4096, 16)]


def topk_wide_phase(torch, ops, ref, dev) -> None:
    """l2_topk at the LM tier's widths (TOPK_WIDE): the depth is streamed,
    so a 64-query tile fits at every width.  First, the host copy of the
    kernel's smem formula must equal the library's wherever the tests plan
    with it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import cost as W

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
        work = W.l2_topk(nq, n, d, k)
        bms, by = W.bound_ms(work)
        log(f"  time l2_topk [Q={nq} N={n} D={d} k={k}]: kernel_ms={t_k} "
            f"library_ms={t_l} bound_ms={bms} ({by}; at the float32 FMA rate "
            f"{W.bound_ms(work._replace(peak=W.FP32_FLOPS))[0]})")
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


# the lm_archs phase: the other six architectures (src/repro/configs/), card
# against CPU at SMOKE widths in float32 with the flash path forced, then at
# full width with their depth cut (each cut on its log line)
LM_ARCHS = ("deepseek-v3-671b", "mixtral-8x22b", "mamba2-130m", "jamba-1.5-large-398b",
            "qwen2-vl-7b", "hubert-xlarge")
LM_ARCHS_TOL = 1e-4
# flash checks at the new widths against the plain version (name, B, S, T, H,
# KV, Dk, Dv, bf16, causal, window, q_offset, written_upto): the wgmma kernel
# at deepseek-v3's (192, 128) and hubert's (80, 80) in bf16 (rows of 80 as two
# 64-column TMA boxes, the second zero past column 80), the FMA kernel at
# (80, 80), deepseek's SMOKE (24, 16) and (192, 128) in float32; S and T off
# the tiles
FLASH_DKDV_CHECKS = [
    ("MLA causal written_upto", 1, 333, 1000, 8, 8, 192, 128, True, True, 0, 500, 833),
    ("MLA B 2 GQA", 2, 257, 513, 8, 2, 192, 128, True, True, 0, 0, 300),
    ("MLA window", 1, 200, 700, 4, 4, 192, 128, True, True, 128, 300, 700),
    ("width 80 bidirectional", 2, 300, 1000, 4, 4, 80, 80, True, False, 0, 0, None),
    ("width 80 causal offset", 1, 130, 400, 4, 2, 80, 80, True, True, 0, 270, 400),
    ("width 80 window written_upto", 1, 257, 700, 4, 4, 80, 80, True, True, 128, 300, 650),
    ("width 80 float32", 1, 130, 400, 4, 2, 80, 80, False, True, 0, 270, 400),
    ("SMOKE MLA float32", 2, 100, 300, 4, 4, 24, 16, False, True, 0, 200, 290),
    ("MLA float32", 1, 100, 300, 4, 4, 192, 128, False, True, 0, 200, 290),
]
# deepseek-v3 at full width: 61 -> 4 layers (3 dense MLA + 1 MoE MLA), the
# MTP head held; ServeEngine at batch 2 over an 8192-token cache, two
# prompts of 8000 tokens, 16 decode steps a decode path
DS_LAYERS, DS_S_MAX, DS_PROMPT, DS_STEPS = 4, 8192, 8000, 16


def lm_archs_smoke(torch, ops, dev) -> None:
    """(a) The six architectures at SMOKE widths in float32 with
    flash_threshold 32 / flash_chunk 16, card against the CPU port on the
    same weights: a full forward over 64 tokens (frames for hubert), a
    cached prefill of 59 into a 64-token cache and 5 decode steps, every
    logit within LM_ARCHS_TOL; deepseek's absorbed decode against its
    materialized decode on the card."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_cache, init_params

    for arch in LM_ARCHS:
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                                  flash_threshold=32, flash_chunk=16)
        cpu = init_params(cfg, seed=0, device="cpu")
        card = copy.deepcopy(cpu).to(dev)
        rng = np.random.default_rng(1)
        errs = []
        ops.reset_launches()
        if cfg.modality == "audio":
            e = torch.from_numpy(rng.normal(size=(2, 64, cfg.d_model)).astype(np.float32))
            got = forward(card, cfg, embeds=e.to(dev)).logits.cpu()
            errs.append(float((got - forward(cpu, cfg, embeds=e).logits).abs().max()))
        else:
            toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)))
            got = forward(card, cfg, tokens=toks.to(dev)).logits.cpu()
            errs.append(float((got - forward(cpu, cfg, tokens=toks).logits).abs().max()))
            s = 59
            caches = {w: init_cache(cfg, 2, 64, device=w) for w in ("cpu", dev)}
            outs = {w: forward(m, cfg, tokens=toks[:, :s].to(w), cache=caches[w], cache_len=0)
                    for w, m in (("cpu", cpu), (dev, card))}
            errs.append(float((outs[dev].logits.cpu() - outs["cpu"].logits).abs().max()))
            if cfg.attn_type == "mla":
                absorbed = [{k: v.clone() for k, v in layer.items()} for layer in caches[dev]]
                cfg_abs = dataclasses.replace(cfg, mla_absorbed_decode=True)
            rel = 0.0
            for j in range(s, 64):
                step = {w: forward(m, cfg, tokens=toks[:, j:j + 1].to(w), cache=caches[w],
                                   cache_len=j).logits
                        for w, m in (("cpu", cpu), (dev, card))}
                errs.append(float((step[dev].cpu() - step["cpu"]).abs().max()))
                if cfg.attn_type == "mla":
                    a = forward(card, cfg_abs, tokens=toks[:, j:j + 1].to(dev), cache=absorbed,
                                cache_len=j).logits
                    rel = max(rel, float((a - step[dev]).abs().max() / step[dev].abs().max()))
            if cfg.attn_type == "mla":
                log(f"  {arch} SMOKE: absorbed against materialized decode on the card, "
                    f"max relative diff {rel} (reference bound 2e-2)")
                if not rel < 2e-2:
                    raise AssertionError(f"lm_archs {arch}: absorbed decode off by {rel}")
        counts = {k: v for k, v in ops.LAUNCHES.items() if v}
        log(f"  {arch} SMOKE float32 card against CPU: max abs err {max(errs)} over "
            f"{len(errs)} calls (forward, prefill, decode steps); launches {counts}")
        if not max(errs) <= LM_ARCHS_TOL:
            raise AssertionError(f"lm_archs {arch}: card and CPU differ by {max(errs)}")
        has_attention = cfg.layer_pattern != "ssm"
        if has_attention and not ops.LAUNCHES["flash_attention"]:
            raise AssertionError(f"lm_archs {arch}: the flash kernel never launched")
        del cpu, card


def lm_archs_kernel_checks(torch, ops, ref, dev) -> None:
    """(b) The flash kernels at the new (Dk, Dv) pairs against the plain
    version: bf16 within one bf16 rounding, float32 within 1e-4, each on
    the kernel `flash_kernel_for` names."""
    g = torch.Generator(device=dev).manual_seed(4)
    for (name, b, s, t, h, kv, dk, dv, bf16, causal, window, q_off, wu) in FLASH_DKDV_CHECKS:
        dt = torch.bfloat16 if bf16 else torch.float32
        q = torch.randn(b, s, h, dk, device=dev, generator=g).to(dt)
        k = torch.randn(b, t, kv, dk, device=dev, generator=g).to(dt)
        v = torch.randn(b, t, kv, dv, device=dev, generator=g).to(dt)
        kw = dict(causal=causal, window=window, q_offset=q_off, written_upto=wu)
        ops.reset_launches()
        got = ops.flash_attention(q, k, v, **kw)
        kernel = ops.flash_kernel_for(dt, dk, dv)
        if ops.LAUNCHES[kernel] != 1 or sum(ops.LAUNCHES.values()) != 1:
            raise AssertionError(f"flash {name}: launches {ops.LAUNCHES}, expected {kernel}")
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        what = (f"flash {name} [{kernel}] B={b} S={s} T={t} H={h} KV={kv} Dk={dk} Dv={dv} "
                f"causal={causal} window={window} q_offset={q_off} written_upto={wu}")
        if got.shape != want.shape:
            raise AssertionError(f"{what}: shape {tuple(got.shape)}")
        if bf16:
            check_bf16(torch, what, got, want)
        else:
            e = float((got - want).abs().max())
            log(f"  {what}: max_abs_err={e}")
            if not e <= 1e-4:
                raise AssertionError(f"{what}: {e} > 1e-4")
    # a pair no kernel is built for raises on the card, with no fallback
    for dk, dv in ((96, 96), (192, 192)):
        q = torch.zeros(1, 8, 2, dk, device=dev, dtype=torch.bfloat16)
        kv = torch.zeros(1, 8, 2, dk, device=dev, dtype=torch.bfloat16)
        try:
            ops.flash_attention(q, kv, kv[..., :dv].contiguous())
        except NotImplementedError:
            continue
        raise AssertionError(f"flash_attention took (Dk, Dv) = ({dk}, {dv})")
    log("  flash (96, 96) and (192, 192): NotImplementedError, as no kernel is built for them")


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def lm_archs_deepseek(torch, ops, dev, card: str) -> None:
    """(c) deepseek-v3 at full width, 4 layers: ServeEngine prefills of two
    8000-token prompts (4 wgmma flash launches each at (Dk 192, Dv 128)),
    16 decode steps with the materialized and with the absorbed decode;
    the first tokens equal."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=DS_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params, init_ms = _timed(torch, lambda: init_params(cfg, seed=0, device=dev))
    n_params = sum(p.numel() for p in params.parameters())
    log(f"lm_archs deepseek-v3-671b [{card}]: full width, n_layers 61 -> {DS_LAYERS} "
        f"(3 dense MLA + 1 MoE MLA; MTP head held), {n_params} parameters "
        f"({n_params * 2 / 1e9} GB bf16) drawn in {init_ms} ms")
    rng = np.random.default_rng(0)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab, DS_PROMPT)) for _ in range(2)]
    key = ops.flash_key((1, DS_PROMPT, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim),
                        (1, DS_S_MAX, cfg.n_heads, 0), True, 0, DS_PROMPT, cfg.v_head_dim)
    done = {}
    for absorbed in (False, True):
        c = dataclasses.replace(cfg, mla_absorbed_decode=absorbed)
        eng = ServeEngine(params, c, batch=2, s_max=DS_S_MAX)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_tokens=DS_STEPS)
        ops.reset_launches()
        admitted, prefill_ms = _timed(torch, eng._admit)
        prefill_launches = dict(ops.LAUNCHES)
        at_key = ops.SHAPE_LAUNCHES[("flash_attention_wgmma", key)]
        MAIN_SHAPES.update(ops.SHAPE_LAUNCHES)
        ops.reset_launches()
        steps, decode_ms = _timed(torch, lambda: sum(1 for _ in iter(eng.step, False)))
        MAIN_SHAPES.update(ops.SHAPE_LAUNCHES)
        done[absorbed] = {k: list(v) for k, v in eng.done.items()}
        path = "absorbed" if absorbed else "materialized"
        log(f"  deepseek-v3 {path} decode: prefill_ms_per_request={prefill_ms / admitted} "
            f"({admitted} prompts of {DS_PROMPT} into {DS_S_MAX}) decode_steps={steps} "
            f"decode_tokens_per_s={2 * DS_STEPS / (decode_ms / 1e3)} "
            f"step_ms={decode_ms / steps} prefill launches={prefill_launches} "
            f"at {key}: {at_key}; decode launches={dict(ops.LAUNCHES)} "
            f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
        if at_key != 4 * admitted or prefill_launches["flash_attention_wgmma"] != 4 * admitted:
            raise AssertionError(f"deepseek-v3: {at_key} wgmma flash launches at {key} for "
                                 f"{admitted} prefills of {DS_LAYERS} MLA layers")
        if len(done[absorbed]) != 2 or any(len(v) != DS_STEPS + 1
                                           for v in done[absorbed].values()):
            raise AssertionError(f"deepseek-v3 {path}: finished {done[absorbed]}")
        del eng
        torch.cuda.empty_cache()
    first = [done[False][i][0] == done[True][i][0] for i in range(2)]
    same = sum(a == b for i in range(2) for a, b in zip(done[False][i], done[True][i]))
    log(f"  deepseek-v3: first tokens equal {first}; {same} of {2 * (DS_STEPS + 1)} tokens "
        f"equal between the decode paths; peak memory {torch.cuda.max_memory_allocated()}")
    if not all(first):
        raise AssertionError("deepseek-v3: the decode paths' first tokens differ")
    del params
    torch.cuda.empty_cache()


def lm_archs_rest(torch, ops, dev, card: str) -> None:
    """(d) mixtral (2 layers), mamba2 (all 24), qwen2-vl (2) and hubert (2)
    at full width: a prefill of about 8192 positions (qwen2-vl: 1024 patch
    embeddings and 7000 tokens with M-RoPE ids; hubert: an encoder forward
    over 8192 frames), then greedy decode steps, logits finite, the flash
    kernel once a layer at its key."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.models import forward, init_cache, init_params
    from repro_torch.serve.engine import make_decode_step, make_prefill
    from repro_torch.train.batching import synthetic_batch

    runs = [("mixtral-8x22b", 2, 8192, 32, 4096), ("mamba2-130m", 24, 8192, 64, 8192 + 64),
            ("qwen2-vl-7b", 2, 8024, 16, 8192), ("hubert-xlarge", 2, 8192, 0, 0)]
    for arch, n_layers, s, steps, s_max in runs:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=n_layers)
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, seed=0, device=dev)
        g = torch.Generator(device=dev).manual_seed(5)
        ops.reset_launches()
        if cfg.modality == "audio":
            embeds = torch.randn(1, s, cfg.d_model, device=dev, generator=g).bfloat16()
            out, prefill_ms = _timed(torch, lambda: forward(params, cfg, embeds=embeds))
            finite, decode = bool(torch.isfinite(out.logits).all()), "encoder-only: no decode"
            del out
        else:
            if cfg.modality == "vision":
                batch = synthetic_batch(cfg, ShapeSpec("prefill", s, 1, "prefill"), seed=0,
                                        device=dev)
            else:
                batch = {"tokens": torch.randint(0, cfg.vocab, (1, s), device=dev,
                                                 generator=g)}
            cache = init_cache(cfg, 1, s_max, device=dev)
            (logits, cache), prefill_ms = _timed(
                torch, lambda: make_prefill(cfg, s_max)(params, batch, cache))
            finite = bool(torch.isfinite(logits[:, -1]).all())
            last = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            del logits
            decode_step = make_decode_step(cfg)

            def run_decode(last=last, cache=cache):
                for j in range(steps):
                    p3 = (torch.full((3, 1, 1), s + j, device=dev, dtype=torch.int32)
                          if cfg.pos_emb == "mrope" else None)
                    last, lg, cache = decode_step(params, cache, last, s + j, positions3=p3)
                return bool(torch.isfinite(lg).all())

            ok, decode_ms = _timed(torch, run_decode)
            finite = finite and ok
            decode = f"decode_tokens_per_s={steps / (decode_ms / 1e3)} steps={steps}"
        MAIN_SHAPES.update(ops.SHAPE_LAUNCHES)
        flash = {k: v for k, v in ops.SHAPE_LAUNCHES.items() if k[0].startswith("flash")}
        log(f"lm_archs {arch} [{card}]: full width, n_layers {full.n_layers} -> {n_layers}, "
            f"prefill S={s} s_max={s_max}: prefill_ms={prefill_ms} {decode} "
            f"logits_finite={finite} flash launches={flash} "
            f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
        if not finite:
            raise AssertionError(f"lm_archs {arch}: non-finite logits")
        n_attn = sum(cfg.is_attn_layer(i) for i in range(n_layers))
        if sum(flash.values()) != n_attn:
            raise AssertionError(f"lm_archs {arch}: {sum(flash.values())} flash launches for "
                                 f"{n_attn} attention layers")
        if cfg.modality == "audio":
            # hubert's (80, 80) encoder on the wgmma kernel, the FMA one never
            key = ops.flash_key((1, s, cfg.n_heads, cfg.head_dim),
                                (1, s, cfg.n_kv_heads, cfg.head_dim), False, 0, s)
            at_key = flash.get(("flash_attention_wgmma", key), 0)
            if ops.LAUNCHES["flash_attention"] or at_key != n_attn:
                raise AssertionError(f"lm_archs {arch}: {ops.LAUNCHES['flash_attention']} FMA "
                                     f"flash launches and {at_key} wgmma ones at {key}, "
                                     f"expected 0 and {n_attn}")
        del params
        torch.cuda.empty_cache()


def lm_archs_phase(torch, ops, ref, dev, card: str) -> None:
    """The other six architectures: (a) SMOKE card against CPU, (b) the
    flash kernels at the new widths, (c) deepseek-v3 at full width, (d)
    mixtral, mamba2, qwen2-vl and hubert at full width, reduced depth
    (jamba's one full-width unit of 8 layers holds 4 MoE layers of 19.3 GB
    each: more than one card; it runs in (a) only)."""
    t0 = time.perf_counter()
    lm_archs_smoke(torch, ops, dev)
    log(f"lm_archs: (a) SMOKE card against CPU {time.perf_counter() - t0} s")
    t1 = time.perf_counter()
    lm_archs_kernel_checks(torch, ops, ref, dev)
    log(f"lm_archs: (b) kernel checks {time.perf_counter() - t1} s")
    t1 = time.perf_counter()
    lm_archs_deepseek(torch, ops, dev, card)
    log(f"lm_archs: (c) deepseek-v3 {time.perf_counter() - t1} s")
    t1 = time.perf_counter()
    lm_archs_rest(torch, ops, dev, card)
    log(f"lm_archs: (d) {time.perf_counter() - t1} s; phase {time.perf_counter() - t0} s")


# the C5 checks: k beyond the 128 the kernels kept before (fig4's k' 160,
# 400 at --full, and the cap), each against the plain version at k + 1;
# the server oracle at fig4's k' (build_policy sizes it kmax = k')
LARGE_K = (160, 400, 1024)
LARGE_K_Q, ORACLE_KMAX_FIG4 = 64, 160


def large_k_phase(torch, ops, ref, catalog, reqs, ivf_index, dev) -> None:
    """C5: topk_l2 (with tombstones), ivf_scan_topk and ivf_scan_lists at
    k 160 / 400 / 1024 on the card against their plain versions, the host
    copies of the smem formulas at those k, then ServerOracle(kmax=160) at
    1M x 128 (its launches counted by shape into MAIN_SHAPES)."""
    from repro_torch.core import baselines as B
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    lib = _build.load("ivf_scan_lists")
    for d in (16, 33, 128, 256):
        for vec4 in ((0, 1) if d % 4 == 0 else (0,)):
            for k in (10, 64, 128) + LARGE_K:
                host = ops.ivf_scan_lists_smem_bytes_host(d, vec4, k)
                card = lib.ivf_scan_lists_smem_bytes(d, vec4, k)
                if host != card:
                    raise AssertionError(f"ivf_scan_lists smem at d={d} vec4={vec4} k={k}: "
                                         f"host copy {host}, ivf_scan_lists.cu {card}")
    log("large k: ivf_scan_lists' smem formula, host copy equal to the library's")
    g = torch.Generator(device=dev).manual_seed(21)
    q = reqs[:LARGE_K_Q].contiguous()
    valid = torch.rand(catalog.shape[0], device=dev, generator=g) > 0.1
    probe = ivf_index.probe_lists(q)
    cand = ivf_index.probe_table(q)
    for k in LARGE_K:
        qt = ops.topk_l2_query_tile(LARGE_K_Q, D_FULL, k, ops.l2_topk_smem_bytes_host)
        gd, gi = ops.topk_l2(q, catalog, k, valid=valid)
        wd, wi = ref.l2_topk_ref(q, catalog, k + 1, valid)
        compare(torch, f"topk_l2 k={k} {LARGE_K_Q} x {N_FULL} x {D_FULL}, 10% tombstoned "
                f"(query tile {16 * qt})", gd, wd, (gi, wi))
        dead = ~valid[gi.clamp_min(0).long()] & (gi >= 0)
        if bool(dead.any()):
            raise AssertionError(f"topk_l2 k={k}: a tombstoned row surfaced")
        gd, gi = ops.ivf_scan_topk(q, catalog, cand, k)
        wd, wi = ref.ivf_scan_ref(q, catalog, cand, k + 1)
        compare(torch, f"ivf_scan_topk k={k} B={LARGE_K_Q} P={cand.shape[1]}", gd, wd,
                (gi, wi))
        gd, gi = ops.ivf_scan_lists(q, catalog, ivf_index.invlists, probe, k,
                                    lens=ivf_index.lens)
        compare(torch, f"ivf_scan_lists k={k} B={LARGE_K_Q} nprobe={probe.shape[1]}", gd, wd,
                (gi, wi))
        del gd, gi, wd, wi
    torch.cuda.synchronize()
    log(f"large k: kernel checks {time.perf_counter() - t0} s")

    ops.reset_launches()
    t0 = time.perf_counter()
    oracle = B.ServerOracle(catalog.cpu().numpy(), reqs.cpu().numpy(), kmax=ORACLE_KMAX_FIG4,
                            device=dev)
    torch.cuda.synchronize()
    key = ("l2_topk", ops.l2_topk_key(ORACLE_BLOCK, N_FULL, D_FULL, ORACLE_KMAX_FIG4))
    n_pre = -(-T_FULL // ORACLE_BLOCK)
    log(f"large k: ServerOracle(kmax={ORACLE_KMAX_FIG4}) precompute at {N_FULL} x {D_FULL}, "
        f"{T_FULL} requests: {time.perf_counter() - t0} s, launches "
        f"{dict(ops.SHAPE_LAUNCHES)}")
    if ops.SHAPE_LAUNCHES[key] != n_pre:
        raise AssertionError(f"large k: the oracle launched l2_topk "
                             f"{ops.SHAPE_LAUNCHES[key]} times at {key[1]}, expected {n_pre}")
    wd, wi = ref.l2_topk_ref(q, catalog, ORACLE_KMAX_FIG4 + 1)
    compare(torch, f"ServerOracle(kmax={ORACLE_KMAX_FIG4}) answers of the first "
            f"{LARGE_K_Q} requests (host distances)",
            torch.from_numpy(oracle.d2[:LARGE_K_Q]).to(dev), wd,
            (torch.from_numpy(oracle.ids[:LARGE_K_Q]).to(dev), wi))
    MAIN_SHAPES.update(ops.SHAPE_LAUNCHES)
    del oracle
    torch.cuda.empty_cache()


# the train phase: qwen1.5-0.5b at full width (24 layers, tied embeddings,
# bf16, AdamW) over 8192 tokens through the launcher, and SMOKE card
# against CPU in float32 with flash forced for four mixer families
TRAIN_ARCH, TRAIN_SEQ, TRAIN_STEPS = "qwen1.5-0.5b", 8192, 6
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--seq-len", str(TRAIN_SEQ), "--log-every", "1"]
TRAIN_SMOKE_ARCHS = ("qwen1.5-0.5b", "mixtral-8x22b", "deepseek-v3-671b", "mamba2-130m")
TRAIN_TOL = 1e-4


def train_flash_key(ops, cfg, b: int = 1):
    """The flash launch key of the training forward: q = k = (B, S, H, D),
    causal, keys up to T (no written_upto)."""
    shape = (b, TRAIN_SEQ, cfg.n_heads, cfg.head_dim)
    kv = (b, TRAIN_SEQ, cfg.n_kv_heads, cfg.head_dim)
    return ops.flash_key(shape, kv, cfg.causal, cfg.sliding_window, TRAIN_SEQ)


def train_smoke(torch, ops, dev) -> None:
    """(b) One training step at SMOKE size in float32 with the flash path
    forced, card against CPU on the same weights and batch: loss, grad norm
    and each leaf's gradient (within TRAIN_TOL x the leaf's largest |g|)."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.train import OptConfig, init_opt, init_train_state, make_train_step
    from repro_torch.train.data import SyntheticDataset, to_device
    from repro_torch.train.optimizer import param_groups

    for arch in TRAIN_SMOKE_ARCHS:
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                                  flash_threshold=32, flash_chunk=16)
        batch = SyntheticDataset(cfg, ShapeSpec("train", 48, 2, "train"), seed=1).batch(0)
        model_cpu, _ = init_train_state(cfg, seed=0, device="cpu")
        models = {"cpu": model_cpu, dev: copy.deepcopy(model_cpu).to(dev)}
        out = {}
        for where, model in models.items():
            params = dict(model.named_parameters())
            opt = init_opt(cfg.optimizer, params, param_groups(cfg, params))
            step = make_train_step(cfg, OptConfig(name=cfg.optimizer))
            ops.reset_launches()
            _, _, m = step(model, opt, to_device(batch, cfg, where), 0)
            out[where] = (float(m.loss), float(m.grad_norm),
                          {n: g.detach().float().cpu() for n, g in step.grads.items()},
                          dict(ops.LAUNCHES))
        (l0, n0, g0, _), (l1, n1, g1, launched) = out["cpu"], out[dev]
        worst = max(float((g1[n] - g0[n]).abs().max()) /
                    max(float(g0[n].abs().max()), 1e-30) for n in g0)
        finite = all(bool(torch.isfinite(g).all()) for g in g1.values())
        log(f"train smoke {arch} (float32, flash_threshold 32, {cfg.optimizer}): loss "
            f"cpu={l0} cuda={l1} grad_norm cpu={n0} cuda={n1}; worst leaf gradient "
            f"err / max|g| = {worst} ({len(g0)} leaves); launches on the card "
            f"{ {k: v for k, v in launched.items() if v} }")
        if not finite:
            raise AssertionError(f"train smoke {arch}: non-finite gradients on the card")
        if abs(l1 - l0) > TRAIN_TOL * abs(l0) or abs(n1 - n0) > TRAIN_TOL * abs(n0):
            raise AssertionError(f"train smoke {arch}: loss or grad norm differ by more "
                                 f"than {TRAIN_TOL} relative")
        if worst > TRAIN_TOL:
            raise AssertionError(f"train smoke {arch}: a leaf's gradient differs by "
                                 f"{worst} x its max")
        if cfg.layer_pattern != "ssm" and launched["flash_attention"] == 0:
            raise AssertionError(f"train smoke {arch}: the flash kernel never launched")


def train_full(torch, ops, card: str) -> None:
    """(a) qwen1.5-0.5b at full width through the launcher: 6 steps at batch
    1, then 2 at accum 2 over batch 2; launches counted by shape into
    MAIN_SHAPES."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as lm_train

    cfg = get_config(TRAIN_ARCH)
    key = ("flash_attention_wgmma", train_flash_key(ops, cfg))
    for label, extra, per_step in (
            ("batch 1", ["--batch", "1", "--steps", str(TRAIN_STEPS)], 2 * cfg.n_layers),
            ("accum 2 over batch 2", ["--batch", "2", "--accum", "2", "--steps", "2"],
             4 * cfg.n_layers)):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fig = lm_train.main(TRAIN_ARGV + extra)
        dt = time.perf_counter() - t0
        losses, steps = fig["losses"], fig["step_ms"]
        flash = [n["flash_attention_wgmma"] for n in fig["launches"]]
        at_key = [c[key] for c in fig["shape_launches"]]
        grads = fig["attn_grads"]
        log(f"train {TRAIN_ARCH} full width {label}, seq {TRAIN_SEQ} [{card}]: {dt} s; "
            f"losses={losses} grad_norms={fig['grad_norms']}")
        log(f"  step_ms={steps} median_step_ms (steps 2 on)={fig['median_step_ms']} "
            f"peak_memory_bytes={fig['peak_bytes']} ({fig['peak_bytes'] / 2 ** 30} GiB)")
        log(f"  flash_attention_wgmma launches a step={flash} at {key[1]}: {at_key}; "
            f"FMA flash launches={[n['flash_attention'] for n in fig['launches']]}")
        log(f"  attention gradients: {len(grads)} tensors, max|g| from "
            f"{min(grads.values())} to {max(grads.values())}")
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"train {label}: non-finite loss")
        if label == "batch 1" and not losses[-1] < losses[0]:
            raise AssertionError(f"train {label}: the last loss {losses[-1]} is not below "
                                 f"the first {losses[0]}")
        if any(n != per_step for n in flash) or any(n != per_step for n in at_key) or any(
                n["flash_attention"] for n in fig["launches"]):
            raise AssertionError(f"train {label}: flash_attention_wgmma launched {flash} "
                                 f"times a step ({at_key} at the training key), expected "
                                 f"{per_step}")
        for name in ("wq", "wk", "wv", "bq", "bk", "bv"):
            got = [v for n, v in grads.items() if n.endswith(f"mixer.{name}")]
            if len(got) != cfg.n_layers or not all(math.isfinite(v) and v > 0 for v in got):
                raise AssertionError(f"train {label}: {name} gradients {got}")
        MAIN_SHAPES.update(ops.SHAPE_LAUNCHES)


def train_phase(torch, ops, ref, catalog, reqs, ivf_index, dev, card: str) -> None:
    t0 = time.perf_counter()
    large_k_phase(torch, ops, ref, catalog, reqs, ivf_index, dev)
    log(f"train: (c) the C5 checks {time.perf_counter() - t0} s")
    t1 = time.perf_counter()
    train_smoke(torch, ops, dev)
    log(f"train: (b) SMOKE card against CPU {time.perf_counter() - t1} s")
    t1 = time.perf_counter()
    train_full(torch, ops, card)
    log(f"train: (a) full width {time.perf_counter() - t1} s; phase "
        f"{time.perf_counter() - t0} s")


def train_profile(torch, ops, card: str) -> None:
    """The attention backward's share of a full-width step, from
    torch.profiler over the last of two steps (run after every timed
    phase: the profiler's callbacks slow later launches)."""
    from repro_torch.launch import train as lm_train

    fig = lm_train.main(TRAIN_ARGV + ["--batch", "1", "--steps", "2", "--profile"])
    prof = fig["profile"]
    log(f"train profile [{card}]: traced step_ms={prof['step_ms']} kernel "
        f"device_ms={prof['device_ms']} attn_backward_device_ms="
        f"{prof['attn_backward_device_ms']} ({prof['attn_backward_spans']} spans of the "
        f"range {ops.FLASH_BACKWARD_RANGE}) share of the step's kernel time="
        f"{prof['attn_backward_share']}, of its wall time="
        f"{prof['attn_backward_device_ms'] / prof['step_ms']} (torch.profiler); device "
        f"idle share of the traced step={1 - prof['device_ms'] / prof['step_ms']}")
    if not prof["attn_backward_share"]:
        raise AssertionError("train profile: the trace attributes no kernel time to the "
                             "attention backward")


def main() -> int:
    only = sys.argv[2] if sys.argv[1:2] == ["--only"] and len(sys.argv) == 3 else None
    if sys.argv[1:] and only not in ("serving", "sharded", "moe_ep", "tp", "long", "cost",
                                     "figures"):
        print("usage: chip_smoke.py [--only serving|sharded|moe_ep|tp|long|cost|figures]",
              file=sys.stderr)
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
        if only == "serving":
            serving_phase(torch, ops, dev)
        elif only == "moe_ep":
            moe_ep_phase(torch, ops, dev, card)
        elif only == "tp":
            tp_phase(torch, ops, dev, card)
        elif only == "long":
            long_phase(torch, dev, card)
        elif only == "cost":
            cost_phase(torch, ops, dev, card)
        elif only == "figures":
            cat_np, reqs_np, _ = trace.sift_like(n=N_FULL, d=D_FULL, t=T_FULL, seed=0)
            figures_phase(torch, ops, dev, cat_np, reqs_np)
        else:
            cat_np, reqs_np, _ = trace.sift_like(n=N_FULL, d=D_FULL, t=T_FULL, seed=0)
            sharded_phase(torch, ops, ref, torch.from_numpy(cat_np).to(dev),
                          torch.from_numpy(reqs_np).to(dev), dev)
            sharded_nccl_profile(torch, dev)
        log(f"total: {time.perf_counter() - t_start} s (--only {only}: no result)")
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
    c_f, oracle = policies_phase(torch, ops, cat_np, reqs_np, dev)
    figures_phase(torch, ops, dev, cat_np, reqs_np, c_f, oracle)
    del cat_np, reqs_np, oracle
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
    lm_archs_phase(torch, ops, ref, dev, card)
    train_phase(torch, ops, ref, catalog, reqs, ivf_index, dev, card)
    sharded_cases = sharded_phase(torch, ops, ref, catalog, reqs, dev)
    MAIN_SHAPES.update(SHARDED_SHAPES)
    CHURN_SHAPES.update(SHARDED_CHURN_SHAPES)
    moe_ep_phase(torch, ops, dev, card)
    tp_phase(torch, ops, dev, card)
    long_phase(torch, dev, card)
    # last: once torch.profiler has traced the card, every later launch in
    # this process pays its callbacks, so no host-clock figure comes after
    rows = shapes_phase(torch, ops, ref, catalog, reqs, ivf_index, pq_index, dev,
                        churn_cases, sharded_cases)
    train_profile(torch, ops, card)
    sharded_nccl_profile(torch, dev)
    del ivf_index, pq_index, catalog, reqs, churn_cases, sharded_cases
    torch.cuda.empty_cache()
    cost_phase(torch, ops, dev, card)
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
    # the serving and figures phases' shapes: each a row's (none expected
    # new: they are the retrieval slice's, the churn path's and the
    # policies phase's)
    for counts in (SERVING_SHAPES, SERVING_CHURN_SHAPES, FIGURES_SHAPES):
        for (name, dims), n in sorted(counts.items()):
            rowed = any(shape_launches(Counter({(name, dims): 1}), *r["key"])
                        for r in rows)
            log(f"serving / figures path {name} {dims} x {n}: "
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
