"""The work of one launch of each of the port's kernels, and the hook that
adds it to the open cost records.

Each function takes a kernel's launch shape (the key `ops` counts the
launch under in `ops.SHAPE_LAUNCHES`: `ops.l2_topk_key`, `ops.pq_adc_key`,
`ops.flash_key`) and returns its `Work`: the FLOPs, the bytes it must
move (each input read once, each output written once), the bytes of its
outputs, and the peak rate of the units that run its operations.
Where the work depends on the data (the distinct rows an id table names,
its valid slots, the slots of the lists a batch probes, a tombstone mask),
a caller that has the data passes the counts; without them (a launch's
hook, the dry-run's meta tensors) the function counts the shape's: every
slot valid and distinct.

These are the formulas of PERF.md §6's bound column:
`scripts/kernel_shapes.py` computes its `bound_ms` from them, so the table's
bounds and the cost record (`repro_torch.launch.cost`) cannot drift apart.
The rates are the H100 SXM's (dense): HBM 3.35 TB/s, float32 FMA 67
TFLOP/s, TF32 tensor cores 495, bf16 tensor cores 989.

A kernel launch is a ctypes call that no `TorchDispatchMode` sees, so
every wrapper in `kernels.ops` hands its launch's work to `add_launch`,
which adds it to each record that `open_record` holds open: a launch on
the card, and a meta call, where the wrapper returns empty outputs of the
kernel's shapes and launches nothing.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12   # dense TF32 tensor cores (l2_topk's products)
BF16_FLOPS = 989e12   # dense bf16 tensor cores (the wgmma flash kernel's)


class Work(NamedTuple):
    flops: float      # operations (a multiply-add is two)
    bytes: float      # each input read once, each output written once
    out_bytes: float  # the outputs' bytes
    peak: float       # FLOP/s of the units that run the operations


def bound_ms(w: Work) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card takes for
    `w`, the larger of its bytes over HBM's rate and its operations over
    its units' peak."""
    t_bytes, t_ops = w.bytes / HBM_BYTES_PER_S * 1e3, w.flops / w.peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pairwise_l2(nq: int, n: int, d: int, m: int = 1) -> Work:
    """(Q, N) float32 distances of Q queries against N rows of width D, m
    pairs at once (`pairwise_l2_batched`): the operands and the matrix
    once; a multiply-add a query, row and dimension (float32 FMAs)."""
    out = 4.0 * m * nq * n
    return Work(2.0 * m * nq * n * d, 4.0 * m * (nq * d + n * d) + out, out, FP32_FLOPS)


def l2_topk(nq: int, n: int, d: int, k: int, *, live: int | None = None,
            masked: bool = False) -> Work:
    """The fused scan's k best (distance, id) a query over N rows: the live
    rows (all N unless given) and the queries once, a byte a row of the
    tombstone mask when `masked`, the (Q, k) output; a multiply-add a
    query, live row and dimension on the TF32 tensor cores."""
    rows = n if live is None else live
    out = 8.0 * nq * k
    return Work(2.0 * nq * rows * d, 4.0 * (rows * d + nq * d) + (n if masked else 0) + out,
                out, TF32_FLOPS)


def ivf_scan(b: int, p: int, d: int, k: int, *, nvalid: int | None = None,
             ndistinct: int | None = None) -> Work:
    """The per-query scan of a (B, P) id table: each distinct named row once
    (B P unless given), the table, the queries, the (B, k) output; three
    operations a valid slot (B P unless given) and dimension."""
    nvalid = b * p if nvalid is None else nvalid
    ndistinct = b * p if ndistinct is None else ndistinct
    out = 8.0 * b * k
    return Work(3.0 * nvalid * d, 4.0 * (ndistinct * d + b * p + b * d) + out, out,
                FP32_FLOPS)


def ivf_scan_lists(b: int, nprobe: int, cap: int, d: int, k: int, *, nlist: int,
                   nvalid: int | None = None, ndistinct: int | None = None,
                   mask_bytes: int = 0) -> Work:
    """The list-major IVF probe: each distinct probed row and its id once
    (B nprobe cap unless given), the probe table, the list lengths, the
    queries, `mask_bytes` of tombstones (a byte a probed slot when masked),
    the (B, k) output; three operations a valid slot and dimension."""
    slots = b * nprobe * cap
    nvalid = slots if nvalid is None else nvalid
    ndistinct = slots if ndistinct is None else ndistinct
    out = 8.0 * b * k
    return Work(3.0 * nvalid * d,
                4.0 * (ndistinct * (d + 1) + b * nprobe + nlist + b * d) + mask_bytes + out,
                out, FP32_FLOPS)


def pq_adc(b: int, p: int, m: int, c: int, *, nvalid: int | None = None,
           ndistinct: int | None = None) -> Work:
    """The ADC scan of B queries at P slots (the dense form's P = N): the
    (B, P) ids and output, each distinct code row of M bytes once (P a
    query unless given), the LUTs; an add a valid slot and subspace."""
    nvalid = b * p if nvalid is None else nvalid
    ndistinct = b * p if ndistinct is None else ndistinct
    out = 4.0 * b * p
    return Work(float(nvalid * m), 8.0 * b * p + ndistinct * m + 4.0 * b * m * c, out,
                FP32_FLOPS)


def pq_adc_lists(b: int, nprobe: int, cap: int, m: int, kk: int, *, c: int, nlist: int,
                 width: int, slots: int | None = None, nvalid: int | None = None,
                 masked: bool = False) -> Work:
    """The IVF-PQ shortlist: each probed list's code rows and ids once at
    their true lengths (`slots`, B nprobe cap unless given), a byte a slot
    of liveness when `masked`, the probe table, the lengths, the LUTs, the
    (B, width) partials written; an add a valid slot and subspace."""
    slots = b * nprobe * cap if slots is None else slots
    nvalid = slots if nvalid is None else nvalid
    out = 8.0 * b * width
    return Work(float(nvalid * m),
                slots * (m + (5.0 if masked else 4.0)) + 4.0 * (b * nprobe + nlist + b * m * c)
                + out, out, FP32_FLOPS)


def kept_pairs(b: int, s: int, t: int, causal: bool, window: int, q_offset: int,
               written_upto: int | None) -> int:
    """(query, key) pairs the flash mask keeps, summed over the batch: query
    i (position q_offset + i) keeps keys [max(0, pos - window + 1), min(T,
    written_upto, pos + 1)) (causal), [.., min(T, written_upto)) else."""
    pos = q_offset + np.arange(s, dtype=np.int64)
    hi = np.full_like(pos, t if written_upto is None else max(0, min(t, written_upto)))
    if causal:
        hi = np.minimum(hi, pos + 1)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros_like(pos)
    return b * int(np.maximum(hi - lo, 0).sum())


def flash_attention(b: int, s: int, t: int, h: int, kv: int, dk: int, dv: int, *,
                    causal: bool, window: int = 0, q_offset: int = 0,
                    written_upto: int | None = None, itemsize: int = 2) -> Work:
    """The flash forward: q, k, v read once and the (B, S, H, Dv) output
    written, in `itemsize`-byte elements; 2 (Dk + Dv) operations a kept
    (query, key) pair and head (q k^T and p v), on the bf16 tensor cores
    (`itemsize` 2) or float32 FMAs (4)."""
    pairs = kept_pairs(b, s, t, causal, window, q_offset, written_upto)
    out = float(itemsize * b * s * h * dv)
    return Work(2.0 * (dk + dv) * h * pairs,
                float(itemsize * (b * s * h * dk + b * t * kv * (dk + dv))) + out, out,
                BF16_FLOPS if itemsize == 2 else FP32_FLOPS)


# the records open now (`open_record`); a kernel launch and a counted
# collective add to each
_OPEN: list = []


@contextlib.contextmanager
def open_record(record):
    """Hold `record` open: every kernel launch (and meta call) inside calls
    `record.add_kernel(kernel, work)`, every counted collective of
    `core.distributed` `record.add_collective(primitive, operand bytes)`."""
    _OPEN.append(record)
    try:
        yield record
    finally:
        _OPEN.remove(record)


def add_launch(kernel: str, work: Work) -> None:
    for record in list(_OPEN):
        record.add_kernel(kernel, work)


def add_collective(primitive: str, nbytes: int) -> None:
    for record in list(_OPEN):
        record.add_collective(primitive, nbytes)
