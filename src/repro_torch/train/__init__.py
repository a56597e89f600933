"""Training substrate of the port (port of `repro.train`).  Here so far:
the straggler monitor, which the resilient serving tier reuses, and the
batch construction serving needs (`batching`: the stubbed vision and
audio prefixes).  The training loop, checkpoints, data and the optimizer
are ROADMAP A10's training half."""

from repro_torch.train.fault import StragglerMonitor

__all__ = ["StragglerMonitor"]
