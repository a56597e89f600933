"""Mirror maps for Online Mirror Ascent (paper Sec. IV-E, Fig. 6).

For the negative entropy the OMA step composes to the multiplicative
update z = y * exp(eta * g); for the squared Euclidean norm it is plain
gradient ascent.  Port of `repro.core.mirror`.
"""

from __future__ import annotations

import torch

NEGENTROPY = "negentropy"
EUCLIDEAN = "euclidean"

# exp-argument clip: keeps the multiplicative update finite for large
# eta*g without changing the argmax structure of the projection.
_EXP_CLIP = 60.0


def dual_ascent_step(y: torch.Tensor, g: torch.Tensor, eta,
                     mirror: str) -> torch.Tensor:
    """z_{t+1} = (grad Phi)^{-1}(grad Phi(y_t) + eta g_t)   (lines 3-5, Alg. 1)."""
    if mirror == NEGENTROPY:
        return y * torch.exp(torch.clamp(eta * g, -_EXP_CLIP, _EXP_CLIP))
    if mirror == EUCLIDEAN:
        return y + eta * g
    raise ValueError(f"unknown mirror map {mirror!r}")
