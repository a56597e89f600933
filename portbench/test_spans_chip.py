"""The program's waits on the card, checked on the card: a few steps of each
closed cell's configuration, at its size and with its traffic, warn under
CUDA's sync debug mode once for each wait the program's recorder counts
(`repro_torch.spans`), and a CUDA + CPU profile of those steps holds every
span as a host range and no user annotation (which kineto would mirror on
the device's timeline).

    python -m pytest portbench/test_spans_chip.py -m chip -s   (on a CUDA card)
"""

from __future__ import annotations

import traceback
import warnings

import pytest
import torch

from portbench import bench, traffic
from portbench.systems import acai

BENCH = bench.load_json(bench.ROOT / "BENCHMARK.json")
CLOSED = next(m["workloads"] for m in BENCH["per_layer"] if m["name"] == "syncs_per_step.sat")
SEED = 2 ** 32 + 17
STEPS = 4


def _serve_counting_syncs(cache, rs, u) -> list:
    """One step; the Python stack at each sync warning raised inside
    `serve_update_batch` (turning the mode on may flush one of its own)."""
    torch.cuda.synchronize()
    stacks = []

    def show(message, *args, **kw):
        stack = traceback.extract_stack()
        if ("synchroniz" in str(message)
                and any(f.name == "serve_update_batch" for f in stack)):
            stacks.append("".join(traceback.format_list(stack[-8:-1])))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            m = cache.serve_update_batch(rs, u)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    m.gain_int.cpu()
    return stacks


@pytest.mark.chip
@pytest.mark.parametrize("cell", CLOSED)
def test_sync_warnings_are_the_recorded_waits(cell, card):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans

    spec = bench.Spec(cell)
    system = acai.System(spec.config, SEED, card)
    traf = traffic.make_traffic(spec.mix, system.catalog, SEED, 1.0,
                                spec.config["catalog"]["seed"])
    b = traf.batch
    system.warm([b])
    batches = [system.catalog_host[traf.ids[i * b:(i + 1) * b]] for i in range(STEPS)]
    gen = torch.Generator(device=card).manual_seed(SEED)
    n = system.catalog.shape[0]
    stacks = [_serve_counting_syncs(system.cache, rs,
                                    torch.rand(n, generator=gen, device=card))
              for rs in batches]
    syncs = [len(s) for s in stacks]
    waits = spans.snapshot()["waits"][-STEPS:].tolist()
    print(f"{cell}: sync warnings a step {syncs}, recorded waits {waits}")
    for i, s in enumerate(stacks):
        if len(s) != waits[i]:
            print(f"step {i}'s syncs:\n" + "\n".join(s))
    assert syncs == waits == [4] * STEPS

    u = torch.rand(n, generator=gen, device=card)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for rs in batches:
            system.cache.serve_update_batch(rs, u)
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.name.startswith("acai.")]
    assert {e.name for e in ev} == {f"acai.{p}" for p in spans.PHASES}
    assert not any(e.is_user_annotation for e in ev)
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in ev)
    assert not any(e.is_user_annotation and "acai" in e.name for e in prof.events())
    snap = spans.snapshot()
    assert snap["profiled"][-STEPS:].all() and not snap["profiled"][:-STEPS].any()
    system.release()
