"""Host time a step of the candidate generator, less its waits, in ms: the
median of the program's spans `candidates.remote` (the index query and the
remote slab), `candidates.local` (the cached rows' slab) and
`candidates.assemble`, less the waits inside them, over the steps
`host_step_ms.sat` reads."""

from portbench import bench

PHASES = ("candidates.remote", "candidates.local", "candidates.assemble")


def read(ctx):
    return bench.plugin("metrics", "host_step_ms.sat").median(
        lambda s: sum(s[f"{p}_ns"] - s[f"{p}_wait_ns"] for p in PHASES) / 1e6)
