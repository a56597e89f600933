"""Fault tolerance and straggler detection (port of `repro.train.fault`).

* `TrainLoop`: checkpoint every N steps, resume from the latest checkpoint
  on (re)start, a bounded restart budget.  Failures are whatever the step
  function raises (injected exceptions in the tests).
* `StragglerMonitor`: a window of step times; flags a step slower than
  `threshold x` the window's median.  The resilient serving tier
  (`repro_torch.serve.resilience`) reuses it per request.
* `reshard`: move a whole state tree to a device (the reference's mesh
  form is ROADMAP A11b).
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Callable, Optional

import torch

from repro_torch.train import checkpoint

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


def reshard(tree, device):
    """Every tensor leaf of `tree` moved to `device` (a new tree)."""
    return checkpoint.unflatten(tree, {k: v.to(device) for k, v in
                                       checkpoint.flatten(tree).items()})


def synchronize(tree) -> None:
    """Wait for the card's work on any leaf of `tree` (the reference's
    block_until_ready)."""
    if any(isinstance(t, torch.Tensor) and t.is_cuda
           for t in checkpoint.flatten(tree).values()):
        torch.cuda.synchronize()


class TrainLoop:
    """Restartable training loop around a step function
    (state, batch, step) -> state."""

    def __init__(self, step_fn: Callable, state, ckpt_dir: str,
                 ckpt_every: int = 50, max_restarts: int = 3,
                 monitor: Optional[StragglerMonitor] = None):
        self.step_fn = step_fn
        self.state = state
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.monitor = monitor or StragglerMonitor()
        self.restarts = 0

    def _resume_step(self) -> int:
        latest = checkpoint.latest_step(self.ckpt_dir)
        if latest is None:
            return 0
        self.state = checkpoint.restore(self.ckpt_dir, latest, self.state)
        log.info("resumed from step %d", latest)
        return latest

    def run(self, num_steps: int, batch_fn: Callable):
        """Runs to `num_steps`, restarting from the latest checkpoint on
        failure (up to max_restarts)."""
        step = self._resume_step()
        while step < num_steps:
            try:
                t0 = time.time()
                self.state = self.step_fn(self.state, batch_fn(step), step)
                synchronize(self.state)
                self.monitor.record(step, time.time() - t0)
                step += 1
                if step % self.ckpt_every == 0 or step == num_steps:
                    checkpoint.save(self.ckpt_dir, step, self.state)
            except Exception:  # noqa: BLE001 — restart path
                self.restarts += 1
                log.exception("step %d failed (restart %d/%d)", step,
                              self.restarts, self.max_restarts)
                if self.restarts > self.max_restarts:
                    raise
                step = self._resume_step()
        return self.state
