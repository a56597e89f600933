"""Host time a step spent waiting on the card, in ms: the median of the sum of
the program's waits (`repro_torch.spans.wait`: the batch's upload, the
finite checks' read-backs, the cached rows' `nonzero`), over the steps
`host_step_ms.sat` reads."""

from portbench import bench


def read(ctx):
    return bench.plugin("metrics", "host_step_ms.sat").median(lambda s: s["wait_ns"] / 1e6)
