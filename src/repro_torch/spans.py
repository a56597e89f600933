"""Host time of the AÇAI serving step by phase, and the host's waits on the
card: the port's one timer on the serving step.

Each `AcaiCache` owns a `Recorder`; `serve_update_batch` opens a step on
it (`with recorder.step():`), and the code the step runs marks its phases
with `span(name)` and the points where the host blocks on the stream with
`wait(name)`.  At the step's end the step's record goes into the
recorder's ring: its start (`time.perf_counter_ns`, the harness's clock),
the batch size, the ns of each phase, the ns of the waits inside each
phase, the number of waits and their ns, and whether a profiler recorded.

Host timing is always on: a span reads the clock at entry and exit and
adds the difference to the open step's record.  Only while torch.profiler
(kineto) records does a span also open `_RecordFunctionFast("acai.<name>")`,
a plain host range on the trace's own clock; it adds no device-side event
(`record_function` is a user annotation, which kineto mirrors on the
device's timeline, and costs ~10x more with no profiler).  A span outside
an open step times nothing that is kept: the step clears the record at its
entry.

Phases (`PHASES`) of the batched step, as `AcaiCache.serve_update_batch`
runs it: `step` (entry to return), the wait `upload` (a batch from the
host to the cache's device), the wait `check_finite` (the read-back of
`index.base.check_finite_queries`, at each of its calls), the candidate
generator's `candidates.remote` (the index query and the remote slab),
`candidates.local` (the cached rows' slab) and `candidates.assemble`, then
`serve` (the gathers, Eq. (2), the gain and subgradient), `scatter`, `oma`
(the OMA step with its projection) and `round`
(`policy.finish_step_batched`).  Each name is one slot of the record, so a
span does not nest inside itself.

`snapshot()` gives the records of the recorder built last (the last
`AcaiCache`), oldest first; the module keeps that recorder after its cache
is freed.  The ring holds the newest `CAPACITY` steps, preallocated.
"""

from __future__ import annotations

import array
import time

import numpy as np
import torch

PHASES = ("step", "upload", "check_finite", "candidates.remote", "candidates.local",
          "candidates.assemble", "serve", "scatter", "oma", "round")
WAITS = ("upload", "check_finite")
# the phases that are not waits and open directly inside `step`; every wait
# opens either directly inside `step` or inside one of these
STEP_PHASES = ("candidates.remote", "candidates.local", "candidates.assemble", "serve",
               "scatter", "oma", "round")
CAPACITY = 8192

# the record's columns: five of the step, then (ns, ns of waits inside) a phase
_START, _BATCH, _PROFILED, _WAITS, _WAIT_NS = range(5)
_COL = {name: 5 + 2 * i for i, name in enumerate(PHASES)}
NCOL = 5 + 2 * len(PHASES)

_pc = time.perf_counter_ns
_enabled = torch._C._autograd._profiler_enabled
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast

# the open step's record: one buffer, cleared as each step opens and copied
# into its recorder's ring as it closes
_ZERO = array.array("q", bytes(8 * NCOL))
_CUR = array.array("q", _ZERO)


class _State:
    __slots__ = ("open", "last")

    def __init__(self):
        self.open = False      # a step is open
        self.last = None       # the recorder built last


_STATE = _State()


class _Span:
    """A phase: its ns and the ns of the waits inside it go to its slots."""

    __slots__ = ("col", "label", "t0", "w0", "rf")

    def __init__(self, name: str):
        self.col = _COL[name]
        self.label = "acai." + name
        self.rf = None

    def _open(self) -> None:
        self.rf = _RecordFunctionFast(self.label)
        self.rf.__enter__()
        _CUR[_PROFILED] = 1

    def _close(self) -> None:
        rf, self.rf = self.rf, None
        rf.__exit__(None, None, None)

    def __enter__(self):
        if _enabled():
            self._open()
        self.w0 = _CUR[_WAIT_NS]
        self.t0 = _pc()
        return self

    def __exit__(self, *exc):
        dt = _pc() - self.t0
        cur, c = _CUR, self.col
        cur[c] += dt
        cur[c + 1] += cur[_WAIT_NS] - self.w0
        if self.rf is not None:
            self._close()


class _Wait(_Span):
    """A point where the host blocks on the stream: a phase that also counts
    one wait and adds its ns to the step's waits."""

    __slots__ = ()

    def __exit__(self, *exc):
        dt = _pc() - self.t0
        cur, c = _CUR, self.col
        cur[c] += dt
        cur[c + 1] += dt
        cur[_WAITS] += 1
        cur[_WAIT_NS] += dt
        if self.rf is not None:
            self._close()


_SPANS = {name: _Span(name) for name in PHASES if name != "step" and name not in WAITS}
_WAIT_SPANS = {name: _Wait(name) for name in WAITS}


def span(name: str) -> _Span:
    """The phase `name` of `PHASES` (not a wait), as a context manager."""
    return _SPANS[name]


def wait(name: str) -> _Wait:
    """The wait `name` of `WAITS`, as a context manager: a span that also
    counts one host wait."""
    return _WAIT_SPANS[name]


def batch(n: int) -> None:
    """Note the open step's batch size."""
    _CUR[_BATCH] = n


class Recorder:
    """The ring of a cache's step records; the recorder built last is what
    `snapshot()` reads."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.ring = _ZERO * capacity   # capacity records of NCOL, flat
        self.count = 0          # steps recorded, the ring's overwritten ones too
        self._outer = False
        self._t0 = 0
        self._rf = None
        _STATE.last = self

    def step(self) -> "Recorder":
        """A context manager around one serving step.  Inside a step that is
        already open (a step that serves through another) it records
        nothing; a step that raises leaves no record."""
        return self

    def __enter__(self):
        if _STATE.open:
            self._outer = False
            return self
        _STATE.open = self._outer = True
        _CUR[:] = _ZERO
        if _enabled():
            self._rf = _RecordFunctionFast("acai.step")
            self._rf.__enter__()
            _CUR[_PROFILED] = 1
        self._t0 = _CUR[_START] = _pc()
        return self

    def __exit__(self, exc_type, *exc):
        if not self._outer:
            return
        dt = _pc() - self._t0
        _STATE.open = self._outer = False
        if self._rf is not None:
            rf, self._rf = self._rf, None
            rf.__exit__(None, None, None)
        if exc_type is None:
            c = _COL["step"]
            _CUR[c] = dt
            _CUR[c + 1] = _CUR[_WAIT_NS]
            i = self.count % self.capacity * NCOL
            self.ring[i:i + NCOL] = _CUR
            self.count += 1

    def snapshot(self) -> dict:
        """The recorded steps, oldest first (`_columns`)."""
        cap = self.capacity
        n = min(self.count, cap)
        rows = np.frombuffer(self.ring, dtype=np.int64).reshape(cap, NCOL)
        return _columns(rows[(self.count - n + np.arange(n)) % cap])


def _columns(rows: np.ndarray) -> dict:
    """Records as arrays: `start_ns`, `batch`, `profiled` (bool), `waits`,
    `wait_ns`, and for each phase `<name>_ns` and `<name>_wait_ns` (the ns
    of the waits inside it)."""
    out = {"start_ns": rows[:, _START], "batch": rows[:, _BATCH],
           "profiled": rows[:, _PROFILED].astype(bool), "waits": rows[:, _WAITS],
           "wait_ns": rows[:, _WAIT_NS]}
    for name, c in _COL.items():
        out[f"{name}_ns"] = rows[:, c]
        out[f"{name}_wait_ns"] = rows[:, c + 1]
    return out


def snapshot(recorder: Recorder | None = None) -> dict:
    """`recorder`'s records (the recorder built last by default; no rows
    where none was built)."""
    rec = _STATE.last if recorder is None else recorder
    return _columns(np.zeros((0, NCOL), dtype=np.int64)) if rec is None else rec.snapshot()


def self_ns(snap: dict) -> np.ndarray:
    """A step's ns that no phase directly inside it covers: `step` less the
    phases of `STEP_PHASES` and the waits that open directly in `step`."""
    inner = sum(snap[f"{p}_ns"] - snap[f"{p}_wait_ns"] for p in STEP_PHASES)
    return snap["step_ns"] - inner - snap["wait_ns"]


def medians_ms(snap: dict, rows: np.ndarray | None = None) -> dict:
    """The median ms of each phase, of the waits and of the step's own time,
    and the median waits a step, over `rows` (a mask or indices; every
    step by default)."""
    sel = slice(None) if rows is None else rows
    out = {p: float(np.median(snap[f"{p}_ns"][sel])) / 1e6 for p in PHASES}
    out["wait"] = float(np.median(snap["wait_ns"][sel])) / 1e6
    out["self"] = float(np.median(self_ns(snap)[sel])) / 1e6
    out["waits"] = float(np.median(snap["waits"][sel]))
    return out
