"""The yardstick of the rooflines: the work one launch of a kernel needs, and
the least time an H100 SXM takes for it.

A frozen copy of the formulas of `repro_torch/kernels/cost.py` (the ones
this benchmark reads), so that a later change to a kernel or to the
program's own accounting cannot change what a roofline share is measured
against.  Each input byte is counted once and each output byte once; the
operations are the algorithm's least, whatever kernel does them: a distance
by the norm expansion, one multiply-add (two operations) a query, row and
dimension (the norms, a lower order, are left out).

Peaks: NVIDIA's data sheet of the H100 SXM, dense, at its full 700 W limit.
HBM 3.35 TB/s.  The configurations hold float32 products with TF32 off, so
every kernel is held to one peak for float32-accurate products: the fastest
the card has, three TF32 tensor-core products a multiply-add (the split
3xTF32), 495 / 3 = 165 TFLOP/s, above the float32 units' 67 TFLOP/s.
"""

from __future__ import annotations

from typing import NamedTuple

HBM_BYTES_PER_S = 3.35e12
F32_PRODUCT_FLOPS = 495e12 / 3


class Work(NamedTuple):
    flops: float      # operations (a multiply-add is two)
    bytes: float      # each input read once, each output written once


def bound_s(w: Work) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the bytes over
    HBM's rate and the operations over the float32-accurate peak."""
    t_bytes, t_ops = w.bytes / HBM_BYTES_PER_S, w.flops / F32_PRODUCT_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def l2_topk(nq: int, n: int, d: int, k: int) -> Work:
    """The fused flat scan: k best (distance, id) of Q queries over N rows
    of width D; the rows and queries read once, the (Q, k) output written;
    a multiply-add a query, row and dimension."""
    return Work(2.0 * nq * n * d, 4.0 * (n * d + nq * d) + 8.0 * nq * k)


def ivf_scan_lists(b: int, nprobe: int, d: int, k: int, *, nlist: int, nvalid: int,
                   ndistinct: int) -> Work:
    """The list-major IVF probe of B queries: each distinct probed row and its
    id once (`ndistinct`), the (B, nprobe) probe table, the list lengths, the
    queries, the (B, k) output; a multiply-add a valid slot (`nvalid`, a
    query's probed rows summed over the batch) and dimension."""
    return Work(2.0 * nvalid * d,
                4.0 * (ndistinct * (d + 1) + b * nprobe + nlist + b * d) + 8.0 * b * k)


def pairwise_l2(nq: int, n: int, d: int) -> Work:
    """(Q, N) float32 distances of Q queries against N rows of width D: the
    operands read once, the matrix written; a multiply-add a query, row and
    dimension."""
    return Work(2.0 * nq * n * d, 4.0 * (nq * d + n * d) + 4.0 * nq * n)
