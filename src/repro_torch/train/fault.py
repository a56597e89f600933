"""Straggler detection (port of `StragglerMonitor` from `repro.train.fault`).

`StragglerMonitor` keeps a window of step times and flags a step slower
than `threshold x` the window's median.  The resilient serving tier
(`repro_torch.serve.resilience`) reuses it per request to flag slow
remote fetches.  The reference's restartable `TrainLoop` and `reshard`
are ROADMAP A10, with the rest of `train/`.
"""

from __future__ import annotations

import collections
import logging

log = logging.getLogger("repro_torch.fault")


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, window: int = 50,
                 quiet: bool = False):
        self.threshold = threshold
        self.times = collections.deque(maxlen=window)
        self.flagged: list[tuple[int, float]] = []
        # quiet: flag and record without logging (the resilient serving
        # tier reuses the monitor per request; its counters report)
        self.quiet = quiet

    def record(self, step: int, seconds: float) -> bool:
        self.times.append(seconds)
        # true median: an even-length window averages the two middle
        # samples (the upper middle alone biases the threshold high)
        ts = sorted(self.times)
        mid = len(ts) // 2
        med = ts[mid] if len(ts) % 2 else 0.5 * (ts[mid - 1] + ts[mid])
        slow = len(self.times) >= 5 and seconds > self.threshold * med
        if slow:
            self.flagged.append((step, seconds))
            if not self.quiet:
                log.warning("straggler: step %d took %.3fs (median %.3fs)",
                            step, seconds, med)
        return slow
