"""Host time of the serving step, in ms: the median, over the run's steps, of
the program's span `step` (`repro_torch.spans`: `AcaiCache.
serve_update_batch` from entry to return).  The readers of the program's
step records take the steps recorded with no profiler active (the traced
stretches' host cost stays out), leave out each batch size's first step (the
warm-up), and read nothing under 16 steps or where the program keeps no
records."""

import numpy as np

MIN_STEPS = 16


def snapshot():
    """The program's step records (the cache built last), or None."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans.snapshot()


def median(per_step):
    """The median of `per_step(records)` (a value a step) over the steady
    steps with no profiler active, or None."""
    snap = snapshot()
    if snap is None:
        return None
    keep = ~snap["profiled"]
    keep[np.unique(snap["batch"], return_index=True)[1]] = False
    if keep.sum() < MIN_STEPS:
        return None
    return float(np.median(per_step(snap)[keep]))


def read(ctx):
    return median(lambda s: s["step_ns"] / 1e6)
