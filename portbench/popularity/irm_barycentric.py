"""The Independent Reference Model of the paper's SIFT experiments: lambda_i
proportional to the distance of row i from the catalog's barycentre to the
power -beta, beta calibrated so that the ranked popularity falls as
Zipf(`zipf_a`) (a copy of the port's `core/trace.py` `_zipf_calibrate_beta`).
Each request's row by inverse transform from `seed`."""

import numpy as np
import torch

from portbench import traffic


def zipf_calibrate_beta(dist_sorted: np.ndarray, zipf_a: float) -> float:
    """beta such that lambda ~ d^-beta has a Zipf(a) ranked tail: the slope
    of log d against log rank over the body of the ranks, gamma, gives
    beta = a / gamma."""
    n = dist_sorted.shape[0]
    if n < 2:
        return float(zipf_a)
    ranks = np.arange(1, n + 1)
    lo, hi = n // 100 + 1, n // 2
    if hi - lo < 8:
        lo, hi = 0, n
    with np.errstate(all="ignore"):
        gamma = np.polyfit(np.log(ranks[lo:hi]), np.log(dist_sorted[lo:hi] + 1e-12), 1)[0]
    if not np.isfinite(gamma) or gamma <= 0:
        gamma = 1.0
    return float(zipf_a / max(gamma, 1e-3))


def draw(catalog: torch.Tensor, count: int, params: dict, seed: int,
         data_seed: int = 0) -> torch.Tensor:
    bary = torch.mean(catalog, 0, dtype=torch.float64).float()
    dist = torch.linalg.vector_norm(catalog - bary, dim=1)
    beta = zipf_calibrate_beta(torch.sort(dist).values.double().cpu().numpy(),
                               params["zipf_a"])
    lam = (dist.double().cpu().numpy() + 1e-9) ** (-beta)
    cdf = torch.from_numpy(np.cumsum(lam / lam.sum())).to(catalog.device)
    gen = traffic.generator(seed, traffic.POPULARITY, catalog.device)
    u = torch.rand(count, dtype=torch.float64, generator=gen, device=cdf.device)
    return torch.clamp_max(torch.searchsorted(cdf, u * cdf[-1], right=True),
                           cdf.shape[0] - 1)
