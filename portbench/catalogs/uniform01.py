"""`n` rows of width `d`, uniform in [0, 1), drawn on the device from the
configuration's `seed` (the `sift_like` construction of the port's
`core/trace.py`)."""

import torch

from portbench import traffic


def make(spec: dict, device) -> torch.Tensor:
    return torch.rand((spec["n"], spec["d"]),
                      generator=traffic.generator(spec["seed"], traffic.CATALOG, device),
                      device=device)
