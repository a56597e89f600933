"""Device operations (kernels, copies, fills) a step over the traced stretch:
each one a launch the host paid for."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return len(ctx.trace.device) / ctx.trace.steps
