"""The normalized accumulated gain, sum of gain_int / (k c_f T), over the
cell's fixed prefix of T requests of the trace (closed loop)."""


def read(ctx):
    if getattr(ctx, "gains", None) is None or ctx.gains.shape[0] < ctx.nag_prefix:
        return None
    return float(ctx.gains[:ctx.nag_prefix].astype("float64").sum()
                 / (ctx.system.nag_scale * ctx.nag_prefix))
