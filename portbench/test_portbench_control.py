"""The comparison that decides `correct`, shown to fail: the control (the
plain reference with its distance products in TF32, put in the program's
place) and the faults a serving cell can have, each at a CPU size, against
the limits the cells' files set.  The control at the cells' own size runs on
the card (`chip`)."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import bench, control, run

CELLS = [w["name"] for w in bench.load_json(bench.ROOT / "BENCHMARK.json")["workloads"]]


def _over(checks: dict, limits: dict) -> list:
    return [k for k, v in checks.items() if v > limits[k]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell, small):
    spec = small(cell)
    res = run.execute(spec, 2 ** 31 + 5, 0.2, False, torch.device("cpu"),
                      time.perf_counter(), control=True)
    assert res["correct"] is True
    assert _over(res["control"], spec.cellfile["limits"])


def _state_unchanged(monkeypatch):
    from repro_torch.core import policy

    orig = policy.finish_step_batched

    def step(cfg_up, state, *args):
        _, metrics = orig(cfg_up, state, *args)
        return policy.CacheState(state.y, state.x, state.t + args[1], state.gen), metrics

    monkeypatch.setattr(policy, "finish_step_batched", step)


def _half_batch(monkeypatch):
    from repro_torch.core import policy

    orig = policy.scatter_rows_sum

    def scatter(n, ids, vals, valid):
        h = ids.shape[0] // 2
        return orig(n, ids[:h], 2.0 * vals[:h], valid[:h])

    monkeypatch.setattr(policy, "scatter_rows_sum", scatter)


def _answer_altered(monkeypatch):
    from repro_torch.core import gain

    orig = gain.serve_batch

    def serve(d, x, k, c_f):
        r = orig(d, x, k, c_f)
        cost, g = r.cost.clone(), r.gain.clone()
        cost[-1] += 0.5 * c_f
        g[-1] = torch.clamp_min(g[-1] - 0.5 * c_f, 0.0)
        return r._replace(cost=cost, gain=g)

    monkeypatch.setattr(gain, "serve_batch", serve)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(cell, fault, small, monkeypatch):
    spec = small(cell)
    fault(monkeypatch)
    res = run.execute(spec, 2 ** 31 + 6, 0.2, False, torch.device("cpu"),
                      time.perf_counter())
    assert res["correct"] is False
    assert _over({k: v["value"] for k, v in res["checks"].items()}, spec.cellfile["limits"])


@pytest.mark.parametrize("cell", CELLS)
def test_one_altered_answer_a_step_is_seen_at_the_cells_batch(cell, small, monkeypatch):
    """At the cells' batch of 512, one answer a step is over the limit,
    however many requests the open loop's steps gather."""
    spec = small(cell, batch=512)
    _answer_altered(monkeypatch)
    res = run.execute(spec, 2 ** 31 + 6, 0.2, False, torch.device("cpu"),
                      time.perf_counter())
    assert res["correct"] is False
    assert _over({k: v["value"] for k, v in res["checks"].items()},
                 spec.cellfile["limits"]) == ["serve_mismatch"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_the_cells_size(cell, card, capsys):
    assert control.main(["--workload", cell, "--seeds", "1", "2", "3"]) == 0
    summary = capsys.readouterr().out.strip().splitlines()[-1]
    import json

    s = json.loads(summary)
    limits = bench.Spec(cell).cellfile["limits"]
    assert not _over(s["program_max"], limits)
    assert _over(s["control_min"], limits)
