"""The benchmark's tests: the `chip` marker, for tests that need a CUDA card
(each decides in a fixture whether there is one, and skips where there is
not), and the cells cut to a size the CPU holds."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip: python -m pytest portbench -m chip)")
    return torch.device("cuda", 0)


@pytest.fixture
def small():
    return small_spec


def small_spec(cell: str, n: int = 4096, d: int = 32, batch: int = 8, steps: int = 6):
    """A cell of BENCHMARK.json at a CPU size: n rows of width d, batches of
    `batch`, a NAG prefix of `steps` steps, the check's steps among them, a
    traced stretch of two steps; its limits as the cell's file sets them.
    (At width 128 the 16 lists' centroids of 4096 uniform rows crowd the
    centre, and float32 and the reference's float64 part the 4th and 5th
    nearest list often; at the cells' own size they seldom do.)"""
    from portbench import bench

    spec = bench.Spec(cell)
    spec.config = copy.deepcopy(spec.config)
    spec.config["catalog"].update(n=n, d=d)
    if spec.config["index"]["backend"] == "ivf":
        spec.config["index"].update(nlist=16, nprobe=4)
    spec.mix = copy.deepcopy(spec.mix)
    arr = spec.mix["arrivals"]
    if arr["kind"] == "closed":
        arr["batch"] = batch
        spec.mix["max_requests"] = 16 * batch * steps
    else:
        arr["max_batch"] = batch
        arr["rate_rps"] = 20 * batch
    spec.cellfile = copy.deepcopy(spec.cellfile)
    if "nag_prefix" in spec.cellfile:
        spec.cellfile["nag_prefix"] = batch * steps
    else:
        spec.cellfile["check"]["within_steps"] = steps
    spec.cellfile["trace"] = {"skip_steps": 1, "steps": 2}
    return spec
