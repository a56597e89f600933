#!/usr/bin/env python3
"""Device time and call time of the port's kernels at each shape the main
path gives them, on one CUDA card.

    python3 scripts/kernel_shapes.py [--src path/to/checkout/src] [--skip-wide]
    python3 scripts/kernel_shapes.py --designs [pairwise_l2 ivf_scan pq_adc_lists]

For each shape it prints one line with
  - device_ms: the kernel's own time on the card, from torch.profiler's
    kernel events whose name holds the kernel's, summed over the calls;
  - call_ms: CUDA events around back-to-back calls of the wrapper, what a
    caller waits for (the wrapper's other device ops, such as the merge
    sort of a top-k's partials, and host pacing included), taken for
    every shape before the first profiled one;
  - launches: kernel launches of one call;
  - bound_ms / bound_by: bytes over HBM's 3.35 TB/s or the operations over
    the peak of the units the kernel runs them on (float32 FMA 67 TFLOP/s;
    `l2_topk`'s TF32 tensor cores 495, flash's bf16 989), whichever is
    larger (the data-dependent counts, distinct rows, valid slots and the
    lists a batch probes, come from this run's data).  The formulas are
    the package's (`repro_torch/kernels/cost.py`, the cost record's),
    loaded from this checkout whatever `--src` names;
  - plain_ms: the plain version (kernels/ref.py) by CUDA events;
  - library_ms: one PyTorch call that computes the same function.

The shapes (Q x N x D for pairwise_l2): the cached-row scan (B x 864 x
128; 1 and 8 x 864 x 1024 in the semantic tier's flat index), the IVF
coarse quantizer (B x 256 x 128), the PQ tables (B x 256 x 16, 8
subspaces), topk_l2's sample bound (B x 16384 x 128, and at the oracle's
512 and c_f's 256 queries; 1, 8, 512 and 64 x 16384 x 1024), AÇAI's exact
candidate scan (8 x 1M x 128), the semantic tier's exact scan (1 and 8 x
1M x 1024), k-means' assignment (1M x 256 x 128, build time); for ivf_scan the IVF probe (B x
16 lists of the 1M x 128 catalog, k 64) and the IVF-PQ exact re-rank of
the index's ADC shortlist (B x 256, k 64; a random 256 of the probed ids
where the tree's IVFPQIndex has no `shortlist`), at B 8 and 64; l2_topk
at the flat index's B x 1M x 128 (k 64) and the semantic tier's flat
index, 1 and 8 x 1M x 1024 (k 16), the baselines' server oracle (512 x
1M x 128 at k 128, precomputing a trace; 8 x 1M x 128 at k 20, online),
and c_f's calibration (256 x 1M x 128 and 512 x 1M x 1024, k 51); the IVF-PQ shortlist (B x 16 lists,
kk 256) by `pq_adc_lists` and, off the main path now, by the per-query
`pq_adc` over the probed table (alone, and with the sort and gather that
followed it: the parent's shortlist, its call beside the new one's); the
bf16 flash kernel at a 512-token prefill into an 8192-token cache (the
semantic tier's prompts) and at 4096 tokens (the engine's 2048-8000), and
at the other architectures' prefills (FLASH_LM): deepseek-v3's MLA (Dk
192, Dv 128, 128 heads, 8000 tokens into an 8192-token cache), mixtral's
sliding window, qwen2-vl's patch prefix and hubert's bidirectional
encoder at head width 80 (the wgmma kernel; the float32 FMA kernel it ran
on before is timed beside it, off the main path).
The churn path's shapes (`churn_cases`, over `churn_state`: the flat, IVF
and IVF-PQ indexes of the first half of the catalog after 205 one-row
inserts and the expiry of the 205 oldest rows, the state a rolling window
at churn 0.1 leaves after 2048 requests): `l2_topk` masked over the 1M-row
slab (8 x capacity x 128, k 64, `valid` holding the tombstones and the
unused rows), `pairwise_l2` of AÇAI's exact mutable scan (8 x capacity;
8 x 500k before the first insert, 8 x 524288 after a compaction), of the
add-time list assignment (1 x 256 x 128) and of k-means' assignment at a
refresh (500k x 256 x 128), and the IVF probe
and the IVF-PQ shortlist, masked, over the lists the inserts appended to.
The sharded step's shapes (`sharded_cases`, chip_smoke.py's sharded phase):
the exact scan of a shard at B 64, the per-query `ivf_scan` over a shard's
IVF table at B 8 and 64, and every kernel at a 4-card shard's shape
(250000 rows) on one card.
`--src` imports another checkout's `repro_torch` (its kernels are built
from its own sources), so two trees can be timed in one call; features a
tree lacks (the batched PQ tables, the list-major probe, the list-major
shortlist) are taken the way that tree's index takes them.  chip_smoke.py
reuses `cases` and `time_cases`.

`--designs` times instead, with the same columns and the device time of
all the call's kernels beside its own (the merge's sort included), the
designs the wrappers choose between by shape: `pairwise_l2`'s 64 x 64 and
32 x 32 tiles at the shapes that take the 64 x 64 tile, the IVF probe at
B 1 to 64 by the per-query kernel, by the list-major one as planned, and
by the list-major one at 1 to 5 runs a list, the IVF-PQ re-rank at B 1 to
64 by `ivf_scan` as planned and over clusters of 1, 2, 4 and 8 blocks a
query, and the IVF-PQ shortlist at
B 1 to 64 by `pq_adc_lists` at each group size (gmax 8, 4, 2) and split
of a list's groups over blocks (qsplit 1, 2, 4, 8); names after
`--designs` keep those kernels' designs only.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
import time
from pathlib import Path


def _load_work():
    """This checkout's `repro_torch/kernels/cost.py` (each kernel's FLOPs and
    bytes), as a module of its own, so `--src` can import another tree's
    `repro_torch` beside it."""
    path = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "cost.py"
    spec = importlib.util.spec_from_file_location("_kernel_work", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


W = _load_work()
bound_ms = W.bound_ms
N_FULL, D_FULL, T_FULL = 1_000_000, 128, 2048
IVF = {"nlist": 256, "nprobe": 16, "train_iters": 4}
IVFPQ = {"nlist": 256, "nprobe": 16, "m": 8, "refine": 4}  # chip_smoke.py's IVFPQ_FULL
CAP, K_REMOTE, REFINE = 2 * 400 + 64, 64, 4
SEM_N, SEM_D, SAMPLE = 1_000_000, 1024, 16384
SEM_K = 16  # the semantic tier's c_remote: max(4 k, 16) at k 4
# the baselines' server oracle (chip_smoke.py's policies phase): the trace
# precomputed in blocks of 512 queries at kmax 128, the online oracle at
# k max(k', 16) = 20 a batch of 8; c_f calibrated from 256 catalog rows at
# kth 50 (k 51); the semantic tier calibrates from 512 (k 51)
ORACLE_Q, ORACLE_K, ONLINE_K, CF_SAMPLE, CF_K, SEM_CF_SAMPLE = 512, 128, 20, 256, 51, 512
# the oracle at fig4's k' (chip_smoke.py's C5 checks: kmax 160 > 128), and
# the k > 128 timed off the main path (fig4 --full's 400, the cap 1024)
ORACLE_K_FIG4, LARGE_K = 160, (160, 400, 1024)
# flash: qwen1.5-0.5b's heads into an 8192-token cache, the prompt lengths
# timed (a semantic-tier prompt; the engine's, 2048-8000, at 4096)
FLASH_H, FLASH_D, FLASH_T, FLASH_S = 16, 64, 8192, (512, 4096)
# the other architectures' prefills at full width (chip_smoke.py's lm_archs
# phase): (label, B, S, T, H, KV, Dk, Dv, causal, window, written_upto)
FLASH_LM = [
    ("deepseek-v3 MLA prefill", 1, 8000, 8192, 128, 128, 192, 128, True, 0, 8000),
    ("mixtral-8x22b SWA prefill", 1, 8192, 8192, 48, 8, 128, 128, True, 4096, None),
    ("qwen2-vl-7b prefill, 1024 patches + 7000 tokens", 1, 8024, 8192, 28, 4, 128, 128,
     True, 0, 8024),
    ("hubert-xlarge encoder", 1, 8192, 8192, 16, 16, 80, 80, False, 0, None),
    # qwen1.5-0.5b training over 8192 tokens (chip_smoke.py's train phase):
    # every layer's forward and its remat recompute
    ("qwen1.5-0.5b train forward and remat recompute", 1, 8192, 8192, 16, 16, 64, 64,
     True, 0, None),
    # chip_smoke.py's tp phase: qwen2-72b's prefill into a 10240-token cache
    # (the (1, 1) mesh's heads), and a (1, 4) mesh rank's heads (64 / 4
    # query heads, 8 / 4 kv heads: GQA group 8)
    ("qwen2-72b prefill, 8192 tokens into a 10240-token cache", 1, 8192, 10240, 64, 8,
     128, 128, True, 0, 8192),
    ("qwen2-72b (1, 4) mesh share: 16 heads, 2 kv heads", 1, 8192, 8192, 16, 2, 128, 128,
     True, 0, None),
    # and a deepseek-v3 MLA layer's (1, 4) share over 8192 tokens: 128 / 4
    # heads at (Dk, Dv) (192, 128), no cache
    ("deepseek-v3 MLA (1, 4) mesh share: 32 heads", 1, 8192, 8192, 32, 32, 192, 128, True,
     0, None),
]

# kernel-name substrings of each wrapper's kernels in the profiler's events
KERNEL_NAMES = {"pairwise_l2": ("pairwise_l2",), "ivf_scan": ("ivf_scan",),
                "l2_topk": ("l2_topk_kernel",), "pq_adc": ("pq_adc_kernel",),
                "pq_adc_lists": ("pq_adc_lists_kernel",),
                "flash_attention": ("flash_wgmma_kernel",),
                "flash_attention_fma": ("flash_kernel",)}


def pq_adc_library(torch, lut, codes, cand=None):
    """The ADC scan in PyTorch ops (the per-query pq_adc's library
    yardstick): the (B, P, M) code slab gathered, offset into the
    flattened LUT, one torch.gather and a sum over m; cand None is the
    dense form."""
    b, m, c = lut.shape
    rows = codes if cand is None else codes[cand.clamp_min(0).long()]
    idx = rows.long() + torch.arange(m, device=lut.device) * c
    idx = idx.reshape(1 if cand is None else b, -1).expand(b, -1)
    d = torch.gather(lut.reshape(b, m * c), 1, idx).reshape(b, -1, m).sum(-1)
    return d if cand is None else d.masked_fill(cand < 0, float("inf"))


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
    # a trace that comes back with no device events is taken again (seen
    # once on the card, after NCCL worlds had come and gone in the process)
    for attempt in range(3):
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
        if seen:
            return total / iters / 1e3
        print(f"  device_ms: trace {attempt + 1} saw no kernel named like {names}",
              flush=True)
    raise RuntimeError(f"profiler saw no kernel named like {names}")


def time_cases(torch, ops, cases) -> list:
    """For each case: launches a call, call_ms, plain_ms and library_ms by
    CUDA events, then device_ms by torch.profiler in a second pass (once
    the profiler has traced the card, every later launch in the process
    pays its callbacks, so no event timing follows it), and for a case
    marked `all_kernels` the device time of every kernel of its call."""
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
        r["device_all_ms"] = (device_ms(torch, c["fn"], c["iters"], ("",))
                              if c["all_kernels"] else None)
    return out


def _valid_sample(torch, cand, width: int, gen):
    """(B, width) int32: `width` valid ids of each row of cand, drawn at
    random (an IVF-PQ shortlist's rows lie in the probed lists)."""
    w = (cand >= 0).float()
    pos = torch.multinomial(w, width, replacement=False, generator=gen)
    return torch.gather(cand, 1, pos).contiguous()


def case(kernel, label, shape, key, fn, plain, library, bnd, main=True, iters=50, row=None,
         check="close", all_kernels=False) -> dict:
    """One timed shape (the fields `cases` documents)."""
    return {"kernel": kernel, "label": label, "shape": shape, "key": key, "fn": fn,
            "plain": plain, "library": library, "bound": bnd, "main": main,
            "row": main if row is None else row, "check": check,
            "all_kernels": all_kernels, "iters": iters}


def topk_case(torch, ops, ref, label, q, x, k, iters=20, main=True) -> dict:
    """`l2_topk` at (Q, N, D, k), bound by its TF32 tensor-core products."""
    nq, nx, dd = q.shape[0], x.shape[0], q.shape[1]
    return case("l2_topk", label, f"Q={nq} N={nx} D={dd} k={k}", ("l2_topk", (nq, nx, dd, k)),
                lambda: ops.topk_l2(q, x, k), lambda: ref.l2_topk_ref(q, x, k),
                lambda: torch.topk(torch.cdist(q, x), k, largest=False),
                bound_ms(W.l2_topk(nq, nx, dd, k)), iters=iters, main=main)


def l2_case(torch, ops, ref, label, q, x, main=True, iters=50) -> dict:
    """`pairwise_l2` at (Q, N, D)."""
    nq, nx, dd = q.shape[0], x.shape[0], q.shape[1]
    return case("pairwise_l2", label, f"Q={nq} N={nx} D={dd}", ("pairwise_l2", (nq, nx, dd)),
                lambda: ops.pairwise_l2(q, x), lambda: ref.pairwise_l2_ref(q, x),
                lambda: torch.cdist(q, x),
                bound_ms(W.pairwise_l2(nq, nx, dd)), main, iters)


def table_case(torch, ops, ref, label, q, x, cand, k, main=True, iters=20) -> dict:
    """The per-query `ivf_scan` over a (B, P) id table: each distinct row
    named once, the table, the queries, the output; three operations a
    valid slot and dimension."""
    b, p, d = cand.shape[0], cand.shape[1], q.shape[1]
    nvalid = int((cand >= 0).sum())
    ndistinct = int(torch.unique(cand[cand >= 0]).numel())

    def library():
        rows = x[cand.clamp_min(0).long()]
        dd = torch.cdist(q[:, None, :], rows)[:, 0].masked_fill(cand < 0, float("inf"))
        return torch.topk(dd, k, largest=False)

    return case("ivf_scan", label,
                f"B={b} P={p} valid={nvalid} distinct={ndistinct} D={d} k={k}",
                ("ivf_scan", (b, p, d, k)), lambda: ops.ivf_scan_topk(q, x, cand, k),
                lambda: ref.ivf_scan_ref(q, x, cand, k), library,
                bound_ms(W.ivf_scan(b, p, d, k, nvalid=nvalid, ndistinct=ndistinct)),
                main=main, iters=iters)


def sharded_cases(torch, ops, ref, reqs, shards, dev) -> list:
    """The sharded step's shapes (chip_smoke.py's sharded phase) that no
    full-width row has: the exact scan of a shard at B 64, the per-query
    IVF table of a shard's probe at B 8 and 64, and each shape at a 4-card
    shard's size.  `shards`: [(label, catalog shard, its sharded IVF (the
    shard's centroids, lists, nprobe), main), ...]; B 8's exact scan of
    the whole catalog is the full-width "AÇAI exact candidates B 8" row,
    the scan_chunk path's l2_topk the flat index's rows."""
    from repro_torch.kernels.ref import probed_table, smallest_k

    out = []
    for label, x, (centroids, invlists, nprobe), main in shards:
        for b in (8, 64):
            q = reqs[:b].contiguous()
            if b == 64 or not main:
                out.append(l2_case(torch, ops, ref, f"{label}: sharded exact scan B {b}", q,
                                   x, main=main, iters=20))
            if not main:
                out.append(topk_case(torch, ops, ref, f"{label}: scan_chunk B {b}", q, x,
                                     K_REMOTE, main=False))
            probe = smallest_k(ops.pairwise_l2(q, centroids), nprobe)[1]
            cand = probed_table(invlists, probe).to(torch.int32).contiguous()
            out.append(table_case(torch, ops, ref, f"{label}: sharded IVF probe B {b}", q, x,
                                  cand, K_REMOTE, main=main))
    for c in out:  # each a row of chip_smoke.py's kernels line, 4-card ones at 0 launches
        c["row"] = True
    return out


def cases(torch, ops, ref, catalog, reqs, ivf_index, pq_index, dev, wide=True):
    """The main-path shapes as dicts: kernel (the wrapper family timed),
    label, shape, key ((counter, dims) of the launch in
    ops.SHAPE_LAUNCHES, where the tree has it), fn (the call as the tree's
    index makes it), plain (its plain version), library, bound (ms, by),
    main (launched on the serving or LM path), row (a row of chip_smoke.py's
    kernels line: the main-path shapes, and the per-query pq_adc kept for
    comparison), check (how chip_smoke.py holds fn to plain: "close",
    "exact" or "bf16"), all_kernels (also time every kernel of the call),
    iters.  The IVF-PQ re-rank takes the index's shortlist where the tree
    has one (else a random sample of the probed ids)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n, d = catalog.shape
    codebooks = pq_index.codec.codebooks
    out = []

    def add(*a, **kw):
        out.append(case(*a, **kw))

    def topk(label, q, x, k, iters=20, main=True):
        out.append(topk_case(torch, ops, ref, label, q, x, k, iters, main))

    def l2(label, q, x, main=True, iters=50):
        out.append(l2_case(torch, ops, ref, label, q, x, main, iters))

    def pq_cases(b, q):
        """The IVF-PQ shortlist (kk = refine * k) of batch b: by
        `pq_adc_lists` where the tree has it, and by the per-query pq_adc
        over the probed table, alone (a row, off the main path now) and
        with the stable sort and gather that followed it (the parent's
        shortlist, timed beside the new one)."""
        kk = REFINE * K_REMOTE
        probe = pq_index.probe_lists(q)
        lut = pq_index.codec.adc_lut(q)
        cand = pq_index.probe_table(q)
        codes = pq_index.codes
        m, c = lut.shape[1:]
        p, nprobe, cap = cand.shape[1], probe.shape[1], pq_index.invlists.shape[1]
        nvalid = int((cand >= 0).sum())
        ndistinct = int(torch.unique(cand[cand >= 0]).numel())
        lists = torch.unique(probe).long()
        slots = int(pq_index.lens[lists].sum())  # the probed lists' slots, true lengths

        def old(lut=lut, cand=cand, gather=ops.pq_adc_gather):
            vals, pos = ref.smallest_k(gather(lut, codes, cand), kk)
            ids = torch.gather(cand, 1, pos)
            return vals, torch.where(torch.isfinite(vals), ids, torch.full_like(ids, -1))

        def library(lut=lut, cand=cand):
            return torch.topk(pq_adc_library(torch, lut, codes, cand), kk, largest=False)

        if hasattr(ops, "pq_shortlist_lists"):
            nruns, run = ops.pq_lists_plan(pq_index.nlist, cap, nprobe, kk, m, c, b)[:2]
            width = nprobe * nruns * min(kk, run)
            # each probed list's code rows and ids once (at their true
            # lengths), the probe table, the list lengths, the LUTs, the
            # partials written; one add a probed live slot and subspace
            work = W.pq_adc_lists(b, nprobe, cap, m, kk, c=c, nlist=pq_index.nlist,
                                  width=width, slots=slots, nvalid=nvalid)
            add("pq_adc_lists", f"IVF-PQ shortlist B {b}",
                f"B={b} nprobe={nprobe} lists={lists.numel()} slots={slots} M={m} C={c} "
                f"kk={kk} partials={width}", ("pq_adc_lists", (b, nprobe, cap, m, kk)),
                lambda lut=lut, probe=probe: ops.pq_shortlist_lists(
                    lut, pq_index.codes_lists, pq_index.invlists, probe, kk, lens=pq_index.lens),
                lambda lut=lut, probe=probe: ref.pq_shortlist_ref(
                    lut, pq_index.codes_lists, pq_index.invlists, probe, kk),
                library, bound_ms(work), check="exact",
                all_kernels=True)
        # the per-query kernel over the (B, P) table: each distinct named
        # code row once, the table, the LUTs, the output
        add("pq_adc", f"IVF-PQ ADC B {b}, per-query",
            f"B={b} P={p} valid={nvalid} distinct={ndistinct} M={m} C={c}",
            ("pq_adc", (b, p, m, c)), lambda lut=lut, cand=cand: ops.pq_adc_gather(
                lut, codes, cand),
            lambda lut=lut, cand=cand: ref.pq_adc_gather_ref(lut, codes, cand),
            lambda lut=lut, cand=cand: pq_adc_library(torch, lut, codes, cand),
            bound_ms(W.pq_adc(b, p, m, c, nvalid=nvalid, ndistinct=ndistinct)),
            main=False, row=True, check="exact")
        add("pq_adc", f"IVF-PQ shortlist B {b}, per-query pq_adc + sort (parent's)",
            f"B={b} P={p} M={m} C={c} kk={kk}", None, old,
            lambda: old(gather=ref.pq_adc_gather_ref), library,
            bound_ms(W.pq_adc(b, p, m, c, nvalid=nvalid, ndistinct=ndistinct)),
            main=False, check="exact", all_kernels=True)

    def flash_case(s_len):
        """The bf16 flash kernel at one prompt's prefill into the cache:
        causal, keys past the prompt masked (written_upto = S)."""
        g = torch.Generator(device=dev).manual_seed(7 + s_len)
        h, dd, t = FLASH_H, FLASH_D, FLASH_T
        qf = torch.randn(1, s_len, h, dd, device=dev, generator=g).bfloat16()
        kf = torch.randn(1, t, h, dd, device=dev, generator=g).bfloat16()
        vf = torch.randn(1, t, h, dd, device=dev, generator=g).bfloat16()
        kw = dict(causal=True, window=0, q_offset=0, written_upto=s_len)
        kpos = torch.arange(t, device=dev)[None, :]
        mask = (kpos < s_len) & (kpos <= torch.arange(s_len, device=dev)[:, None])
        qt, kt, vt = (a.transpose(1, 2) for a in (qf, kf, vf))
        label = ("semantic-tier prefill" if s_len == 512
                 else "engine prefill (prompts of 2048-8000, timed at 4096)")
        add("flash_attention", label,
            f"B=1 S={s_len} T={t} H={h} KV={h} D={dd} causal written_upto={s_len} bf16",
            ("flash_attention_wgmma", (1, s_len, t, h, h, dd, dd, "causal+written_upto")),
            lambda: ops.flash_attention(qf, kf, vf, **kw),
            lambda: ref.flash_attention_ref(qf.float(), kf.float(), vf.float(), **kw),
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                                     attn_mask=mask),
            bound_ms(W.flash_attention(1, s_len, t, h, h, dd, dd, causal=True,
                                       written_upto=s_len)), check="bf16", iters=20)

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
            bound_ms(W.pairwise_l2(b, ksub, dsub, m)))
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
            work = W.ivf_scan_lists(b, probe.shape[1], ivf_index.invlists.shape[1], d,
                                    K_REMOTE, nlist=ivf_index.lens.numel(), nvalid=nvalid,
                                    ndistinct=ndistinct)
        else:
            fn = lambda q=q, cand=cand: ops.ivf_scan_topk(q, catalog, cand, K_REMOTE)  # noqa: E731
            key = ("ivf_scan", (b, p, d, K_REMOTE))
            # per query: each distinct row once, the (B, P) table, the
            # queries, the output
            work = W.ivf_scan(b, p, d, K_REMOTE, nvalid=nvalid, ndistinct=ndistinct)

        def lib_scan(q, cand):
            rows_ = catalog[cand.clamp_min(0).long()]
            dd = torch.cdist(q[:, None, :], rows_)[:, 0].masked_fill(cand < 0, float("inf"))
            return torch.topk(dd, K_REMOTE, largest=False)

        add("ivf_scan", f"IVF probe B {b}",
            f"B={b} P={p} valid={nvalid} distinct={ndistinct} D={d} k={K_REMOTE}", key, fn,
            lambda q=q, cand=cand: ref.ivf_scan_ref(q, catalog, cand, K_REMOTE),
            lambda q=q, cand=cand: lib_scan(q, cand),
            bound_ms(work), iters=20)
        if hasattr(pq_index, "shortlist"):
            short = pq_index.shortlist(q, K_REMOTE)[1].to(torch.int32).contiguous()
        else:
            short = _valid_sample(torch, cand, REFINE * K_REMOTE, gen)
        out.append(table_case(torch, ops, ref, f"IVF-PQ re-rank B {b}", q, catalog, short,
                              K_REMOTE, iters=50))
        topk(f"flat index B {b}", q, catalog, K_REMOTE)
        pq_cases(b, q)
    # the online engine's partial batches (its batch window forms 1 to 7
    # requests): AÇAI's step over the flat index at each size
    rows = catalog[torch.randperm(n, device=dev, generator=gen)[:CAP]].contiguous()
    for b in range(1, 8):
        q = reqs[:b].contiguous()
        topk(f"flat index, partial batch B {b}", q, catalog, K_REMOTE)
        l2(f"topk_l2 sample bound, partial batch B {b}", q, catalog[:SAMPLE])
        l2(f"cached-row scan, partial batch B {b}", q, rows)
    # the baselines' server oracle and c_f's calibration (queries: requests,
    # and catalog rows for the calibration, as calibrate_fetch_cost takes)
    cal = catalog[torch.randperm(n, device=dev, generator=gen)[:CF_SAMPLE]].contiguous()
    topk(f"server oracle precompute Q {ORACLE_Q}", reqs[:ORACLE_Q].contiguous(), catalog,
         ORACLE_K)
    topk(f"server oracle precompute Q {ORACLE_Q}, fig4's k' {ORACLE_K_FIG4}",
         reqs[:ORACLE_Q].contiguous(), catalog, ORACLE_K_FIG4, iters=5)
    if getattr(ops, "MAX_K", 128) >= max(LARGE_K):
        # k above the 128 the kernels once stopped at (C5), off the main
        # path: checked and timed, no row of chip_smoke.py's kernels line
        topk(f"server oracle precompute Q {ORACLE_Q}, fig4 --full's k' 400",
             reqs[:ORACLE_Q].contiguous(), catalog, 400, iters=5, main=False)
        topk("flat index B 64 at the cap k 1024", reqs[:64].contiguous(), catalog, 1024,
             iters=3, main=False)
        q = reqs[:64].contiguous()
        probe, cand = ivf_index.probe_lists(q), ivf_index.probe_table(q)
        nvalid = int((cand >= 0).sum())
        ndistinct = int(torch.unique(cand[cand >= 0]).numel())
        for k in LARGE_K[:2]:
            add("ivf_scan", f"IVF probe B 64 at c_remote {k}",
                f"B=64 P={cand.shape[1]} valid={nvalid} distinct={ndistinct} D={d} k={k}",
                ("ivf_scan_lists", (64, probe.shape[1], ivf_index.invlists.shape[1], d, k)),
                lambda k=k: ops.ivf_scan_lists(q, catalog, ivf_index.invlists, probe, k,
                                               lens=ivf_index.lens),
                lambda k=k: ref.ivf_scan_ref(q, catalog, cand, k),
                lambda k=k: torch.topk(torch.cdist(q[:, None, :], catalog[
                    cand.clamp_min(0).long()])[:, 0].masked_fill(cand < 0, float("inf")),
                    k, largest=False),
                bound_ms(W.ivf_scan_lists(64, probe.shape[1], ivf_index.invlists.shape[1], d,
                                          k, nlist=ivf_index.lens.numel(), nvalid=nvalid,
                                          ndistinct=ndistinct)),
                iters=10, main=False)
    topk("server oracle online B 8", reqs[:8].contiguous(), catalog, ONLINE_K)
    topk(f"c_f calibration Q {CF_SAMPLE}", cal, catalog, CF_K)
    l2("AÇAI exact candidates B 8", reqs[:8].contiguous(), catalog, iters=20)
    l2(f"topk_l2 sample bound Q {ORACLE_Q}", reqs[:ORACLE_Q].contiguous(), catalog[:SAMPLE])
    l2(f"topk_l2 sample bound Q {CF_SAMPLE}", cal, catalog[:SAMPLE])
    if wide:
        sem = torch.randn(SEM_N, SEM_D, device=dev, generator=gen)
        qs = torch.randn(64, SEM_D, device=dev, generator=gen)
        l2("topk_l2 sample bound 64 x D 1024", qs, sem[:SAMPLE], main=False)
        sem_cal = sem[torch.randperm(SEM_N, device=dev, generator=gen)[:SEM_CF_SAMPLE]]
        sem_rows = sem[torch.randperm(SEM_N, device=dev, generator=gen)[:CAP]].contiguous()
        for b in (1, 8):
            l2(f"semantic exact scan B {b}", qs[:b].contiguous(), sem, iters=10)
            topk(f"semantic flat index B {b}", qs[:b].contiguous(), sem, SEM_K, iters=10)
            l2(f"semantic topk_l2 sample bound B {b}", qs[:b].contiguous(), sem[:SAMPLE])
            l2(f"semantic cached-row scan B {b}", qs[:b].contiguous(), sem_rows)
        topk(f"semantic c_f calibration Q {SEM_CF_SAMPLE}", sem_cal.contiguous(), sem, CF_K,
             iters=5)
        l2(f"semantic topk_l2 sample bound Q {SEM_CF_SAMPLE}", sem_cal.contiguous(),
           sem[:SAMPLE], iters=10)
    l2("k-means assignment (build)", catalog, ivf_index.centroids, main=False, iters=3)
    for s_len in FLASH_S:
        flash_case(s_len)
    return out + lm_flash_cases(torch, ops, ref, dev)


def lm_flash_cases(torch, ops, ref, dev) -> list:
    """The flash kernels at the other architectures' prefills (FLASH_LM),
    as `cases` dicts: bf16 inputs drawn from a generator, the kernel the
    wrapper picks (the wgmma one at every FLASH_LM width), the plain
    version on float32 copies, masked scaled_dot_product_attention on k /
    v expanded to every head as the library yardstick; and hubert's shape
    once more on the float32 FMA kernel it ran on before (no row)."""
    out = []
    for i, (label, b, s_len, t, h, kv, dk, dv, causal, window, wu) in enumerate(FLASH_LM):
        g = torch.Generator(device=dev).manual_seed(11 + i)
        qf = torch.randn(b, s_len, h, dk, device=dev, generator=g).bfloat16()
        kf = torch.randn(b, t, kv, dk, device=dev, generator=g).bfloat16()
        vf = torch.randn(b, t, kv, dv, device=dev, generator=g).bfloat16()
        kw = dict(causal=causal, window=window, q_offset=0, written_upto=wu)
        wuu = t if wu is None else wu
        qp = torch.arange(s_len, device=dev)[:, None]
        kp = torch.arange(t, device=dev)[None, :]
        mask = (kp < wuu).expand(s_len, t).clone()
        if causal:
            mask &= kp <= qp
        if window:
            mask &= kp > qp - window
        qt = qf.transpose(1, 2)
        kt, vt = (a.repeat_interleave(h // kv, dim=2).transpose(1, 2) for a in (kf, vf))
        counter = ops.flash_kernel_for(torch.bfloat16, dk, dv)
        mask_kind = ("causal" if causal else "full") + (f" window={window}" if window else "")
        out.append({
            "kernel": "flash_attention" if counter == "flash_attention_wgmma"
            else "flash_attention_fma",
            "label": label,
            "shape": f"B={b} S={s_len} T={t} H={h} KV={kv} Dk={dk} Dv={dv} {mask_kind} "
                     f"written_upto={wuu} bf16",
            "key": (counter, ops.flash_key(qf.shape, kf.shape, causal, window, wuu, dv)),
            "fn": lambda qf=qf, kf=kf, vf=vf, kw=kw: ops.flash_attention(qf, kf, vf, **kw),
            "plain": lambda qf=qf, kf=kf, vf=vf, kw=kw: ref.flash_attention_ref(
                qf.float(), kf.float(), vf.float(), **kw),
            "library": lambda qt=qt, kt=kt, vt=vt, mask=mask:
                torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
            # q, k, v read once, the output written; 2 (Dk + Dv) operations a
            # kept pair and head on the bf16 tensor cores
            "bound": bound_ms(W.flash_attention(b, s_len, t, h, kv, dk, dv, causal=causal,
                                                window=window, written_upto=wu)),
            "main": True, "row": True, "check": "bf16", "all_kernels": False,
            "iters": 5})
        if dk == 80 and counter == "flash_attention_wgmma":
            out.append(dict(out[-1], kernel="flash_attention_fma", key=None, main=False,
                            row=False, label=f"{label}, on the FMA kernel (before)",
                            fn=lambda qf=qf, kf=kf, vf=vf, wuu=wuu, c=causal, w=window:
                            _fma_flash(torch, qf, kf, vf, c, w, wuu)))
    return out


def _fma_flash(torch, q, k, v, causal, window, written_upto):
    """The float32 FMA flash kernel (csrc/flash_attention.cu) on bf16
    inputs, called straight through its library: the kernel bf16 took at
    widths the wgmma kernel did not."""
    from repro_torch.kernels import _build

    b, s, h, dk = q.shape
    t, kv, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    rc = _build.load("flash_attention").flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t, h, kv, dk, dv,
        int(causal), window, 0, written_upto, 1.0 / dk ** 0.5, 1,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention (FMA) failed with CUDA error {rc}")
    return out


CHURN_EVENTS = 205  # rolling_catalog's events at churn 0.1 over 2048 requests


def churn_state(torch, catalog, dev, events: int = CHURN_EVENTS):
    """(flat, ivf, ivfpq) indexes over the first half of `catalog` after
    `events` one-row inserts of the next rows and as many expiries of the
    oldest ones, through the indexes' own add / remove."""
    from repro_torch.index.base import IndexSpec, build_index

    n0 = catalog.shape[0] // 2
    out = []
    for spec in (IndexSpec("flat"), IndexSpec("ivf", IVF), IndexSpec("ivfpq", IVFPQ)):
        idx = build_index(spec, catalog[:n0], device=dev)
        for i in range(events):
            idx.add(catalog[n0 + i:n0 + i + 1])
            idx.remove([i])
        out.append(idx)
    return tuple(out)


def churn_cases(torch, ops, ref, reqs, flat, ivf, pq, dev, b: int = 8):
    """The churn path's main-path shapes as `cases` dicts (same keys), over
    mutated indexes: the masked flat scan, AÇAI's exact scan over the
    slab, the add-time assignment, and the masked IVF probe and IVF-PQ
    shortlist on appended lists.  The bounds count the live rows where the
    kernel skips the dead ones (a row `valid` masks is never read)."""
    out = []
    q = reqs[:b].contiguous()
    cap, d = flat.embeddings.shape
    n_live = flat.n

    def add(kernel, label, shape, key, fn, plain, library, bnd, check="close", iters=20,
            all_kernels=False):
        out.append({"kernel": kernel, "label": label, "shape": shape, "key": key, "fn": fn,
                    "plain": plain, "library": library, "bound": bnd, "main": True,
                    "row": True, "check": check, "all_kernels": all_kernels,
                    "iters": iters})

    slab, valid = flat.embeddings, flat.valid
    # a rolling catalog before its first insert: the warm half, unmasked
    warm = slab[:cap // 2]
    add("l2_topk", f"churn: flat index B {b} before the first insert",
        f"Q={b} N={cap // 2} D={d} k={K_REMOTE}", ("l2_topk", (b, cap // 2, d, K_REMOTE)),
        lambda: ops.topk_l2(q, warm, K_REMOTE), lambda: ref.l2_topk_ref(q, warm, K_REMOTE),
        lambda: torch.topk(torch.cdist(q, warm), K_REMOTE, largest=False),
        bound_ms(W.l2_topk(b, cap // 2, d, K_REMOTE)))
    add("l2_topk", f"churn: flat index masked B {b}",
        f"Q={b} N={cap} live={n_live} D={d} k={K_REMOTE}", ("l2_topk", (b, cap, d, K_REMOTE)),
        lambda: ops.topk_l2(q, slab, K_REMOTE, valid=valid),
        lambda: ref.l2_topk_ref(q, slab, K_REMOTE, valid),
        lambda: torch.topk(torch.cdist(q, slab).masked_fill(~valid, float("inf")), K_REMOTE,
                           largest=False),
        bound_ms(W.l2_topk(b, cap, d, K_REMOTE, live=n_live, masked=True)))
    add("pairwise_l2", f"churn: AÇAI exact candidates B {b}", f"Q={b} N={cap} D={d}",
        ("pairwise_l2", (b, cap, d)), lambda: ops.pairwise_l2(q, slab),
        lambda: ref.pairwise_l2_ref(q, slab), lambda: torch.cdist(q, slab),
        bound_ms(W.pairwise_l2(b, cap, d)))
    # the exact scan before the first insert (the warm half, its own
    # capacity) and after a compaction (the live rows at the smallest
    # doubling that holds them and one write batch more: 524288)
    compacted = slab[:1 << (n_live + 32 - 1).bit_length()]
    for label, x in (("before the first insert", warm), ("after compaction", compacted)):
        nx = x.shape[0]
        add("pairwise_l2", f"churn: AÇAI exact candidates B {b} {label}", f"Q={b} N={nx} D={d}",
            ("pairwise_l2", (b, nx, d)), lambda x=x: ops.pairwise_l2(q, x),
            lambda x=x: ref.pairwise_l2_ref(q, x), lambda x=x: torch.cdist(q, x),
            bound_ms(W.pairwise_l2(b, nx, d)))
    nl = ivf.centroids.shape[0]
    # k-means' assignment step at a refresh: the live rows against the lists'
    # centroids (the slab's first n_live rows stand in for the live ones)
    live_rows = slab[:n_live]
    add("pairwise_l2", "churn: k-means assignment at refresh",
        f"Q={n_live} N={nl} D={d}", ("pairwise_l2", (n_live, nl, d)),
        lambda: ops.pairwise_l2(live_rows, ivf.centroids),
        lambda: ref.pairwise_l2_ref(live_rows, ivf.centroids),
        lambda: torch.cdist(live_rows, ivf.centroids),
        bound_ms(W.pairwise_l2(n_live, nl, d)), iters=5)
    row = reqs[:1].contiguous()
    add("pairwise_l2", "churn: add-time list assignment", f"Q=1 N={nl} D={d}",
        ("pairwise_l2", (1, nl, d)), lambda: ops.pairwise_l2(row, ivf.centroids),
        lambda: ref.pairwise_l2_ref(row, ivf.centroids), lambda: torch.cdist(row, ivf.centroids),
        bound_ms(W.pairwise_l2(1, nl, d)), iters=50)

    probe = ivf.probe_lists(q)
    table = ops.probed_table(ivf.invlists, probe)
    live = (table >= 0) & ivf.valid[table.clamp_min(0).long()]
    nvalid = int(live.sum())
    ndistinct = int(torch.unique(table[live]).numel())
    lists = torch.unique(probe).long()
    cols = ivf.invlists.shape[1]
    add("ivf_scan", f"churn: IVF probe masked B {b}",
        f"B={b} P={table.shape[1]} valid={nvalid} distinct={ndistinct} D={d} k={K_REMOTE} "
        f"appended lists cap={cols}",
        ("ivf_scan_lists", (b, probe.shape[1], cols, d, K_REMOTE)),
        lambda probe=probe: ops.ivf_scan_lists(q, ivf.embeddings, ivf.invlists, probe,
                                               K_REMOTE, valid=ivf.valid, lens=ivf.lens),
        lambda table=table: ref.ivf_scan_ref(q, ivf.embeddings, table, K_REMOTE, ivf.valid),
        lambda table=table, live=live: torch.topk(
            torch.cdist(q[:, None, :], ivf.embeddings[table.clamp_min(0).long()])[:, 0]
            .masked_fill(~live, float("inf")), K_REMOTE, largest=False),
        bound_ms(W.ivf_scan_lists(b, probe.shape[1], cols, d, K_REMOTE, nlist=nl,
                                  nvalid=nvalid, ndistinct=ndistinct,
                                  mask_bytes=int(ivf.lens[lists].sum()))))

    kk = REFINE * K_REMOTE
    probe = pq.probe_lists(q)
    lut = pq.codec.adc_lut(q)
    m, c = lut.shape[1:]
    table = ops.probed_table(pq.invlists, probe)
    live = (table >= 0) & pq.valid[table.clamp_min(0).long()]
    lists = torch.unique(probe).long()
    slots = int(pq.lens[lists].sum())
    cols = pq.invlists.shape[1]
    nruns, run = ops.pq_lists_plan(pq.nlist, cols, probe.shape[1], kk, m, c, b)[:2]
    width = probe.shape[1] * nruns * min(kk, run)
    add("pq_adc_lists", f"churn: IVF-PQ shortlist masked B {b}",
        f"B={b} nprobe={probe.shape[1]} lists={lists.numel()} slots={slots} "
        f"live={int(live.sum())} M={m} C={c} kk={kk} appended lists cap={cols}",
        ("pq_adc_lists", (b, probe.shape[1], cols, m, kk)),
        lambda: ops.pq_shortlist_lists(lut, pq.codes_lists, pq.invlists, probe, kk,
                                       valid=pq.valid, lens=pq.lens),
        lambda: ref.pq_shortlist_ref(lut, pq.codes_lists, pq.invlists, probe, kk, pq.valid),
        lambda: torch.topk(pq_adc_library(torch, lut, pq.codes, table).masked_fill(
            ~live, float("inf")), kk, largest=False),
        # each probed slot's code row, id and liveness once, the probe
        # table, the lengths, the LUTs, the partials written
        bound_ms(W.pq_adc_lists(b, probe.shape[1], cols, m, kk, c=c, nlist=pq.nlist,
                                width=width, slots=slots, nvalid=int(live.sum()),
                                masked=True)),
        check="exact", all_kernels=True)
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


def _forced_scan(ops, cluster):
    """A context in which `ivf_scan_topk` splits every table over a cluster
    of `cluster` blocks (None: as planned)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = ops.ivf_scan_plan
        if cluster is not None:
            ops.ivf_scan_plan = lambda b, p, k: (cluster, -(-p // cluster), cluster)
        try:
            yield
        finally:
            ops.ivf_scan_plan = saved
    return ctx()


def _forced_pq(ops, gmax, qsplit):
    """A context in which `pq_shortlist_lists` holds gmax queries a group
    and splits a list's groups over qsplit blocks (the runs as planned)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = ops.pq_lists_plan
        ops.pq_lists_plan = lambda *a: saved(*a)[:2] + (gmax, qsplit)
        try:
            yield
        finally:
            ops.pq_lists_plan = saved
    return ctx()


def design_cases(torch, ops, catalog, reqs, ivf_index, pq_index, dev):
    """The designs the wrappers pick between, as dicts (kernel, label,
    shape, fn, iters): pairwise_l2's two tiles where the plan takes the
    64 x 64 one, the IVF probe's kernels and the IVF-PQ shortlist's plans
    at B 1 to 64."""
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
        short = pq_index.shortlist(q, K_REMOTE)[1].contiguous()
        for cluster in (None, 1, 2, 4, 8):
            def fn(q=q, short=short, cluster=cluster):
                with _forced_scan(ops, cluster):
                    return ops.ivf_scan_topk(q, catalog, short, K_REMOTE)
            how = (f"as planned {ops.ivf_scan_plan(b, short.shape[1], K_REMOTE)}"
                   if cluster is None else f"cluster {cluster}")
            out.append({"kernel": "ivf_scan", "label": f"IVF-PQ re-rank B {b} {how}",
                        "shape": f"B={b} P={short.shape[1]} k={K_REMOTE}", "fn": fn,
                        "iters": 50})
        kk = REFINE * K_REMOTE
        probe = pq_index.probe_lists(q)
        lut = pq_index.codec.adc_lut(q)
        plan = ops.pq_lists_plan(pq_index.nlist, pq_index.invlists.shape[1], probe.shape[1], kk,
                                 *lut.shape[1:], b)
        for gmax, qsplit in [(None, None)] + [(g, z) for g in (8, 4, 2) for z in (1, 2, 4, 8)]:
            def fn(lut=lut, probe=probe, gmax=gmax, qsplit=qsplit):
                call = lambda: ops.pq_shortlist_lists(  # noqa: E731
                    lut, pq_index.codes_lists, pq_index.invlists, probe, kk, lens=pq_index.lens)
                if gmax is None:
                    return call()
                with _forced_pq(ops, gmax, qsplit):
                    return call()
            how = f"as planned {plan}" if gmax is None else f"gmax {gmax} qsplit {qsplit}"
            out.append({"kernel": "pq_adc_lists", "label": f"IVF-PQ shortlist B {b} {how}",
                        "shape": f"B={b} kk={kk}", "fn": fn, "iters": 20})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--skip-wide", action="store_true",
                    help="leave out the 1M x 1024 shapes")
    ap.add_argument("--designs", nargs="*", default=None,
                    help="time the designs the wrappers choose between instead "
                         "(of the kernels named; none named: all)")
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
    pq_index = IVFPQIndex(catalog, device=dev, **IVFPQ)
    if args.designs is not None:
        cs = [c for c in design_cases(torch, ops, catalog, reqs, ivf_index, pq_index, dev)
              if not args.designs or c["kernel"] in args.designs]
        # event timings of every case first: the profiler slows later launches
        calls = [call_ms(torch, c["fn"], c["iters"]) for c in cs]
        for c, t in zip(cs, calls):
            own = device_ms(torch, c["fn"], c["iters"], KERNEL_NAMES[c["kernel"]])
            every = device_ms(torch, c["fn"], c["iters"], ("",))
            print(f"design | {c['label']} | {c['shape']} | device_ms={own} "
                  f"device_all_kernels_ms={every} call_ms={t}", flush=True)
        return 0
    cs = cases(torch, ops, ref, catalog, reqs, ivf_index, pq_index, dev,
               wide=not args.skip_wide)
    if hasattr(ivf_index, "add"):  # a tree with the mutable catalog
        cs += churn_cases(torch, ops, ref, reqs, *churn_state(torch, catalog, dev), dev)
    for c, r in zip(cs, time_cases(torch, ops, cs)):
        print(f"{c['kernel']} | {c['label']} | {c['shape']} | device_ms={r['device_ms']} "
              f"device_all_kernels_ms={r['device_all_ms']} call_ms={r['call_ms']} "
              f"launches={r['launches']} bound_ms={c['bound'][0]} ({c['bound'][1]}) "
              f"plain_ms={r['plain_ms']} library_ms={r['library_ms']} "
              f"main_path={c['main']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
