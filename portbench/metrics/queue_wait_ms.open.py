"""The open loop's mean wait, over the traced stretch's requests, from a
request's due time to the start of the step that serves it, in ms."""


def read(ctx):
    if ctx.trace is None or getattr(ctx, "latency_s", None) is None:
        return None
    n = sum(r[2] for r in ctx.trace_records)
    return 1e3 * sum(r[3] * r[2] for r in ctx.trace_records) / n
