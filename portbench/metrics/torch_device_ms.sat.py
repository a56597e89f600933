"""Device time a step of every operation that is not one of the port's
hand-written kernels (PyTorch's own kernels, copies and fills), in ms."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    t = sum(e - s for name, s, e in ctx.trace.device if ctx.trace.kernel_name(name) is None)
    return t / 1e3 / ctx.trace.steps
