"""The open loop's mean batch over the traced stretch: requests a step."""


def read(ctx):
    if ctx.trace is None or getattr(ctx, "latency_s", None) is None:
        return None
    return sum(r[2] for r in ctx.trace_records) / len(ctx.trace_records)
