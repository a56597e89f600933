"""Open loop at `rate_rps` (the exponential gaps of the port's
`serve/arrivals.py`) for `seconds`, batched continuously up to
`max_batch`."""

import numpy as np

from portbench import traffic


def schedule(mix: dict, seed: int, seconds: float):
    arr = mix["arrivals"]
    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), traffic.ARRIVALS]))
    rate = arr["rate_rps"]
    gaps = rng.exponential(1.0 / rate, size=int(rate * seconds * 1.2) + 64)
    due = np.cumsum(gaps)
    while due[-1] < seconds:
        due = np.concatenate([due, due[-1] + np.cumsum(
            rng.exponential(1.0 / rate, size=int(rate) + 64))])
    due = due[due < seconds]
    return due.shape[0], arr["max_batch"], due
