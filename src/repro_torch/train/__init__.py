"""Training substrate of the port (port of `repro.train`): optimizers
(AdamW and Adafactor), the train step with gradient accumulation and
remat, the synthetic data pipeline, checkpoints with atomic commits, and
the restartable loop with its straggler monitor (which the resilient
serving tier reuses).  `batching` builds the per-architecture batches
(the stubbed vision and audio prefixes)."""

from repro_torch.train.fault import StragglerMonitor
from repro_torch.train.optimizer import OptConfig, apply_opt, init_opt
from repro_torch.train.train_step import (TrainMetrics, init_train_state, loss_fn,
                                          make_train_step)

__all__ = ["OptConfig", "StragglerMonitor", "TrainMetrics", "apply_opt", "init_opt",
           "init_train_state", "loss_fn", "make_train_step"]
