"""The host's waits on the card a step: the median of the program's count of
its waits (`repro_torch.spans.wait`), over the steps `host_step_ms.sat`
reads."""

from portbench import bench


def read(ctx):
    return bench.plugin("metrics", "host_step_ms.sat").median(lambda s: s["waits"])
