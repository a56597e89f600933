"""Carry state and index structures into the port as numpy arrays.

A cache state or an IVF index built elsewhere (for instance by the JAX
reference) is handed over as plain arrays, so the port never reads a
framework-specific object such as a JAX key.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.policy import CacheState
from repro_torch.index.ivf import IVFFlatIndex


def cache_state_from_numpy(y, x, t: int = 0, seed: int = 0, device=None) -> CacheState:
    """CacheState from (N,) float arrays y and x and the step counter t;
    the step generator is a fresh one on `device`, seeded with `seed`."""
    device = resolve_device(device)
    y = torch.from_numpy(np.array(y, np.float32)).to(device)
    x = torch.from_numpy(np.array(x, np.float32)).to(device)
    return CacheState(y=y, x=x, t=int(t),
                      gen=torch.Generator(device=device).manual_seed(seed))


def ivf_from_numpy(catalog, centroids, invlists, nprobe: int,
                   device=None) -> IVFFlatIndex:
    """IVFFlatIndex over `catalog` (N, d) with prebuilt `centroids`
    (nlist, d) and padded inverted lists `invlists` (nlist, cap; -1 pads)."""
    return IVFFlatIndex(np.array(catalog, np.float32), nprobe=nprobe,
                        centroids=np.array(centroids, np.float32),
                        invlists=np.array(invlists, np.int32), device=device)
