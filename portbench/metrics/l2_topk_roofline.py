"""The flat index's fused scan's share of its roofline, in %: the least time
the H100 takes for the traced steps' scans (the frozen formula of
`portbench/cost.py`: every row and query read once, a multiply-add a query,
row and dimension), over the `l2_topk` kernel's device time."""

from portbench import cost


def read(ctx):
    if ctx.trace is None:
        return None
    t = sum(e - s for name, s, e in ctx.trace.device
            if ctx.trace.kernel_name(name) == "l2_topk") / 1e6
    if t <= 0:
        return None
    n, d = ctx.system.catalog.shape
    k = ctx.system.cfg["c_remote"]
    bound = sum(cost.bound_s(cost.l2_topk(rec[2], n, d, k))[0] for rec in ctx.trace_records)
    return 100.0 * bound / t
