"""Device time a step of the hand-written kernels of the serving step:
`pairwise_l2`, `l2_topk` and `ivf_scan_lists`, in ms."""

KERNELS = ("pairwise_l2", "l2_topk", "ivf_scan_lists")


def read(ctx):
    if ctx.trace is None:
        return None
    t = sum(e - s for name, s, e in ctx.trace.device if ctx.trace.kernel_name(name) in KERNELS)
    return t / 1e3 / ctx.trace.steps if t > 0 else None
