"""Host time a step of the update in plain torch, in ms: the median of the
program's spans `serve` (the gathers, Eq. (2), the gain and subgradient),
`scatter`, `oma` (the OMA step and its projection) and `round` (the
rounding and the metrics), over the steps `host_step_ms.sat` reads."""

from portbench import bench

PHASES = ("serve", "scatter", "oma", "round")


def read(ctx):
    return bench.plugin("metrics", "host_step_ms.sat").median(
        lambda s: sum(s[f"{p}_ns"] for p in PHASES) / 1e6)
