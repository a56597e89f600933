"""Training substrate of the port (port of `repro.train`).  Only the
straggler monitor is here so far, which the resilient serving tier
reuses; the training loop, checkpoints, data and the optimizer are
ROADMAP A10."""

from repro_torch.train.fault import StragglerMonitor

__all__ = ["StragglerMonitor"]
