"""The benchmark's files, found by the names in `BENCHMARK.json`.

- `configs/<config>.json`: a configuration (the file `BENCHMARK.json` names),
  with the system it runs (`systems/<system>.py`);
- `mixes/<traffic>.json`: a traffic mix's parameters, which name the kinds
  of its catalog, popularity and arrivals (`traffic.py`);
- `catalogs/<distribution>.py`, `popularity/<kind>.py`, `arrivals/<kind>.py`:
  the generator of each kind;
- `cells/<cell>.json`: a cell's own settings: the NAG prefix, the steps the
  comparison picks, the traced stretch and the comparison's limits;
- `metrics/<metric>.py`: a metric's reader, `read(ctx)`, which returns its
  value, or None where it finds nothing to read.

A cell, a mix, a kind of traffic or a metric is added by adding files and
entries, with no file here edited.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """`BENCHMARK.json` and the files of one of its cells."""

    def __init__(self, cell: str):
        self.bench = load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if cell not in cells:
            raise KeyError(f"no workload {cell!r} in BENCHMARK.json; have {sorted(cells)}")
        self.workload = cells[cell]
        self.cell = cell
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(ROOT / self.config_entry["file"])
        self.mix = load_json(HERE / "mixes" / f"{self.workload['traffic']}.json")
        self.cellfile = load_json(HERE / "cells" / f"{cell}.json")

    def metrics(self, traced: bool) -> list[dict]:
        """The cell's end-to-end metrics (`traced` False) or per-layer ones."""
        group = self.bench["per_layer" if traced else "end_to_end"]
        return [m for m in group if self.cell in m.get("workloads", [self.cell])]


@functools.lru_cache(maxsize=None)
def plugin(group: str, name: str):
    """The module `<group>/<name>.py` of the benchmark's folder."""
    path = HERE / group / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {group} {name!r}: {path.relative_to(ROOT)} is missing")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{group}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The `read(ctx)` of `metrics/<name>.py`."""
    return plugin("metrics", name).read
