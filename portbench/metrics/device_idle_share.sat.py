"""1 - the union of the device operations' intervals over the traced
stretch's length (closed loop)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 1.0 - ctx.trace.busy_s / ctx.trace.window_s
