"""The serving step's spans and wait counter (`repro_torch.spans`) on the
CPU: one record a step with every phase inside `step`, three waits a step
on a host batch (the upload and the two finite checks), the ring, the
cache built last, the profiler's host ranges, and the benchmark's readers
of the records."""

import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import bench
from repro_torch import spans
from repro_torch.core import policy
from repro_torch.index.base import IndexSpec

N, D, B = 1024, 16, 32
SPECS = {"flat": IndexSpec("flat"), "ivf": IndexSpec("ivf", {"nlist": 8, "nprobe": 2})}
# where each span opens: the phase directly around it
PARENT = {"upload": "step", "candidates.remote": "step", "candidates.local": "step",
          "candidates.assemble": "step", "serve": "step", "scatter": "step", "oma": "step",
          "round": "step"}


def _catalog():
    return np.random.default_rng(0).random((N, D), dtype=np.float32)


def _cache(kind, cat):
    cfg = policy.AcaiConfig(h=32, k=4, c_f=1.0, c_remote=16, c_local=8, index=SPECS[kind])
    return policy.AcaiCache(cat, cfg, device="cpu")


def _serve(cache, cat, steps, batch=B, seed=1):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        cache.serve_update_batch(cat[rng.integers(0, N, batch)])


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_one_record_a_step_with_every_phase_inside_it(kind):
    cat = _catalog()
    cache = _cache(kind, cat)
    _serve(cache, cat, 5)
    snap = spans.snapshot()
    assert snap["step_ns"].shape == (5,) and (snap["batch"] == B).all()
    assert not snap["profiled"].any() and (np.diff(snap["start_ns"]) > 0).all()
    for p in spans.PHASES:
        assert (snap[f"{p}_ns"] > 0).all(), p
        assert (snap[f"{p}_ns"] <= snap["step_ns"]).all(), p
    assert (spans.self_ns(snap) >= 0).all()
    # the cached rows' slab is fixed-width: it reads nothing back
    assert (snap["candidates.local_wait_ns"] == 0).all()
    # the index query's finite check is the remote slab's one wait
    assert (snap["candidates.remote_wait_ns"] > 0).all()
    assert (snap["candidates.remote_wait_ns"] < snap["check_finite_ns"]).all()
    assert (snap["step_wait_ns"] == snap["wait_ns"]).all()


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_four_waits_a_step_on_a_host_batch(kind):
    cat = _catalog()
    cache = _cache(kind, cat)
    _serve(cache, cat, 3)
    snap = spans.snapshot()
    assert snap["waits"].tolist() == [3, 3, 3]
    waits = sum(snap[f"{w}_ns"] for w in spans.WAITS)
    assert (snap["wait_ns"] == waits).all()
    # a batch already on the cache's device is not uploaded: two waits
    cache.serve_update_batch(torch.from_numpy(cat[:B]))
    snap = spans.snapshot()
    assert snap["waits"][-1] == 2 and snap["upload_ns"][-1] == 0


def test_the_ring_wraps_at_its_length():
    rec = spans.Recorder(capacity=4)
    for b in range(1, 7):
        with rec.step():
            spans.batch(b)
            with spans.span("serve"):
                pass
    snap = rec.snapshot()
    assert rec.count == 6 and snap["batch"].tolist() == [3, 4, 5, 6]
    assert (np.diff(snap["start_ns"]) > 0).all() and (snap["serve_ns"] > 0).all()


def test_a_step_that_raises_leaves_no_record():
    cat = _catalog()
    cache = _cache("flat", cat)
    _serve(cache, cat, 2)
    bad = cat[:B].copy()
    bad[3, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        cache.serve_update_batch(bad)
    _serve(cache, cat, 1, batch=8)
    assert spans.snapshot()["batch"].tolist() == [B, B, 8]


def test_spans_outside_a_step_are_not_kept():
    rec = spans.Recorder()
    with spans.wait("upload"):
        pass
    with rec.step():
        spans.batch(1)
    snap = rec.snapshot()
    assert snap["waits"].tolist() == [0] and snap["upload_ns"].tolist() == [0]


def test_snapshot_is_the_cache_built_last_after_it_is_freed():
    cat = _catalog()
    first = _cache("flat", cat)
    _serve(first, cat, 3, batch=16)
    last = _cache("ivf", cat)
    _serve(last, cat, 2, batch=8)
    del last
    gc.collect()
    _serve(first, cat, 4, batch=16)   # an earlier cache's steps stay its own
    snap = spans.snapshot()
    assert snap["batch"].tolist() == [8, 8]
    assert first.spans.snapshot()["batch"].tolist() == [16] * 7


def test_no_profiler_range_without_a_profiler(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            pass

    monkeypatch.setattr(spans, "_RecordFunctionFast", Counting)
    cat = _catalog()
    cache = _cache("flat", cat)
    _serve(cache, cat, 2)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(cache, cat, 1)
    assert sorted(set(entered)) == sorted(f"acai.{p}" for p in spans.PHASES)
    assert spans.snapshot()["profiled"].tolist() == [False, False, True]


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_spans_are_host_ranges_nested_as_the_step(kind):
    cat = _catalog()
    cache = _cache(kind, cat)
    _serve(cache, cat, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(cache, cat, 1)
    ev = [e for e in prof.events() if e.name.startswith("acai.")]
    assert {e.name for e in ev} == {f"acai.{p}" for p in spans.PHASES}
    assert not any(e.is_user_annotation for e in ev)
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in ev)
    by = {}
    for e in ev:
        by.setdefault(e.name[len("acai."):], []).append(e.time_range)

    def within(inner, outer):
        return outer.start <= inner.start and inner.end <= outer.end

    assert len(by["step"]) == 1 and len(by["check_finite"]) == 2
    for child, parent in PARENT.items():
        for r in by[child]:
            assert any(within(r, o) for o in by[parent]), child
    # one finite check in the step itself, one in the index query
    checks = sorted(by["check_finite"], key=lambda r: r.start)
    assert within(checks[0], by["step"][0])
    assert not any(within(checks[0], o) for o in by["candidates.remote"])
    assert any(within(checks[1], o) for o in by["candidates.remote"])


def _synthetic(steps, profiled=(), batches=None):
    """A snapshot of `steps` steps: step i takes i + 1 ms, waits 0.5 ms in
    two waits, its candidates 2 ms with 0.25 ms of waits inside."""
    rows = np.zeros((steps, spans.NCOL), dtype=np.int64)
    snap = spans._columns(rows)
    snap["batch"][:] = 512 if batches is None else batches
    snap["profiled"] = np.isin(np.arange(steps), profiled)
    snap["step_ns"][:] = (np.arange(steps) + 1) * 1_000_000
    snap["wait_ns"][:] = 500_000
    snap["waits"][:] = 2
    snap["candidates.remote_ns"][:] = 1_500_000
    snap["candidates.remote_wait_ns"][:] = 250_000
    snap["candidates.local_ns"][:] = 500_000
    for p in ("serve", "scatter", "oma", "round"):
        snap[f"{p}_ns"][:] = 250_000
    return snap


def _read(monkeypatch, snap, name):
    monkeypatch.setattr(spans, "snapshot", lambda recorder=None: snap)
    return bench.reader(name)(None)


def test_readers_take_the_steady_unprofiled_steps(monkeypatch):
    # steps 0..39 at batch 512; step 0 is the warm-up, 10..19 were profiled
    snap = _synthetic(40, profiled=range(10, 20))
    kept = np.r_[1:10, 20:40] + 1.0        # each step's ms
    for name in ("host_step_ms.sat", "host_step_ms.open"):
        assert _read(monkeypatch, snap, name) == pytest.approx(np.median(kept))
    for name in ("sync_wait_ms.sat", "sync_wait_ms.open"):
        assert _read(monkeypatch, snap, name) == pytest.approx(0.5)
    assert _read(monkeypatch, snap, "syncs_per_step.sat") == 2
    assert _read(monkeypatch, snap, "host_candidates_ms.sat") == pytest.approx(1.75)
    assert _read(monkeypatch, snap, "host_update_ms.sat") == pytest.approx(1.0)


def test_readers_skip_each_batch_size_first_step(monkeypatch):
    # the open loop's sizes: the first step at each of 512, 256, 7 is a warm-up
    batches = np.array([512, 256, 7] + [512, 256, 7] * 6)
    snap = _synthetic(21, batches=batches)
    kept = np.arange(3, 21) + 1.0
    assert _read(monkeypatch, snap, "host_step_ms.open") == pytest.approx(np.median(kept))


@pytest.mark.parametrize("steps,profiled,none", [(17, (), False), (16, (), True),
                                                 (30, range(14), False), (30, range(15), True),
                                                 (0, (), True)])
def test_readers_read_nothing_under_16_steps(monkeypatch, steps, profiled, none):
    snap = _synthetic(steps, profiled=profiled)
    for name in ("host_step_ms.sat", "syncs_per_step.sat", "sync_wait_ms.open"):
        assert (_read(monkeypatch, snap, name) is None) == none


def test_readers_read_nothing_from_a_program_without_spans(monkeypatch):
    import sys

    import repro_torch

    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)   # the import fails
    assert bench.reader("host_step_ms.sat")(None) is None
    assert bench.reader("host_update_ms.sat")(None) is None
