"""What a traced stretch of steps reads from torch.profiler's trace.

`busy_s` is the union of the device operations' intervals (a copy of the
arithmetic of the port's `profile_step._busy_us`), so overlapping operations
count once.  The idle gaps between them are named by what the host was
doing: the innermost host operation open at each gap's middle.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

# the port's hand-written CUDA kernels (`repro_torch/kernels/csrc`), by the
# stem of their device functions' names
HAND_WRITTEN = re.compile(r"\b(pairwise_l2|l2_topk|ivf_scan_lists|ivf_scan|pq_adc_lists|"
                          r"pq_adc|flash_attention)\w*")


@dataclasses.dataclass
class Trace:
    steps: int                      # steps inside the stretch
    window_s: float                 # the stretch's length on the host's clock
    device: list                    # (name, start_us, end_us) of each device operation
    host: list                      # (name, start_us, end_us) of each host operation

    def kernel_name(self, name: str) -> str | None:
        """The hand-written kernel a device operation is, or None."""
        m = HAND_WRITTEN.search(name)
        return None if m is None else m.group(1)

    def union(self) -> list[tuple[float, float]]:
        spans = sorted((s, e) for _, s, e in self.device)
        out = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.union()) / 1e6

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took the most time: [name, seconds]."""
        by = {}
        for name, s, e in self.device:
            by[name[:160]] = by.get(name[:160], 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """The idle time between device operations, summed by the host
        operation open at each gap's middle: [name, seconds]."""
        spans = self.union()
        if len(spans) < 2 or not self.host:
            return []
        hs = np.array([h[1] for h in self.host])
        he = np.array([h[2] for h in self.host])
        by = {}
        for (_, e0), (s1, _) in zip(spans[:-1], spans[1:]):
            mid = 0.5 * (e0 + s1)
            open_ = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = "python between host operations"
            if open_.size:
                name = self.host[open_[np.argmax(hs[open_])]][0][:160]
            by[name] = by.get(name, 0.0) + (s1 - e0) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def from_profile(prof, steps: int, window_s: float) -> Trace:
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        (device if e.device_type == cuda else host).append(span)
    return Trace(steps, window_s, device, host)
