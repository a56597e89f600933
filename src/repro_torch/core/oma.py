"""Online Mirror Ascent — Algorithm 1 of the paper.  Port of `repro.core.oma`.

One AÇAI update: subgradient (core.gain), dual ascent step through the
mirror map (core.mirror), Bregman projection onto the capped simplex
(core.projection), then rounding (core.rounding) by the caller.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import mirror as mirror_maps
from repro_torch.core import projection

Y_FLOOR = 1e-12  # keeps y in the (open) domain of the entropy map


@dataclasses.dataclass(frozen=True)
class OMAConfig:
    eta: float = 1e-2
    mirror: str = mirror_maps.NEGENTROPY
    rounding: str = "coupled"  # 'depround' | 'coupled' | 'independent'
    round_every: int = 1       # the paper's M
    projection_topk: int = 0   # 0 = exact full sort; >0 = accelerated top-A


def project(z: torch.Tensor, h, cfg: OMAConfig) -> torch.Tensor:
    if cfg.mirror == mirror_maps.NEGENTROPY:
        if cfg.projection_topk:
            y = projection.capped_simplex_negentropy_topk(z, h, cfg.projection_topk)
        else:
            y = projection.capped_simplex_negentropy(z, h)
        return torch.clamp(y, Y_FLOOR, 1.0)
    y = projection.capped_simplex_euclidean(z, h)
    return torch.clamp(y, 0.0, 1.0)


def oma_update(y: torch.Tensor, g: torch.Tensor, h, cfg: OMAConfig) -> torch.Tensor:
    """One OMA step (lines 3-6 of Algorithm 1)."""
    z = mirror_maps.dual_ascent_step(y, g, cfg.eta, cfg.mirror)
    return project(z, h, cfg)


def uniform_state(n: int, h: int, device=None,
                  dtype=torch.float32) -> torch.Tensor:
    """y_1 = argmin_{conv(X)} Phi(y) = (h/N, ..., h/N)  (Lemma 8)."""
    return torch.full((n,), h / n, dtype=dtype, device=device)
