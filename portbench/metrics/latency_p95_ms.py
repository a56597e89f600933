"""The 95th percentile over every request of the window of the time from its
due time in the open-loop schedule to its results on the host, in ms."""

import numpy as np


def read(ctx):
    if getattr(ctx, "latency_s", None) is None:
        return None
    return float(np.percentile(ctx.latency_s, 95) * 1e3)
