"""PyTorch/CUDA port of the AÇAI similarity cache (the JAX package `repro`
is the reference it is held against).

The layout follows `repro`: `core/` (cost model, OMA, projection,
rounding, gain, traces, the batched policy step), `index/` (flat and IVF
indexes, candidate generation) and `kernels/` (hand-written Hopper
kernels with their plain PyTorch versions).  Entry points run on the
CUDA card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card by default.

    Raises when CUDA is asked for (explicitly or by default) on a machine
    without it, so a missing card never turns into a quiet CPU run."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the CUDA card by default and this machine "
                "has none; pass device='cpu' to run the plain PyTorch versions")
        if device.index is None:  # compare equal to a tensor's device
            device = torch.device("cuda", torch.cuda.current_device())
    return device
