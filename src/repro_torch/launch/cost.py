"""The cost record of one rank's program (port of `repro.launch.hlo_analysis`).

The reference compiles a cell's step for the production mesh and mines the
per-device HLO text (`hlo_analysis.summarize`).  The port runs eagerly, so
it counts what a rank's program does as it runs: `CostMode`, a
`TorchDispatchMode` around the rank's step (on meta tensors in the
dry-run, on the card where it measures), sees every aten operation below
autograd, forward, backward and a remat recomputation alike; the kernel
wrappers (`kernels.ops`), whose launches no dispatch mode sees, hand it
their work (`kernels.cost`), and so do the counted collectives of
`core.distributed`.  The summary (`CostSummary`) holds the reference's
fields:

  - `flops`: what the reference counts, which is dot FLOPs,
    2 prod(result) prod(contracted) (`hlo_analysis.py:164-177`): the
    aten matmul family (`mm`, `addmm`, `bmm`, `baddbmm`, `mv`, `addmv`,
    `dot`, `addbmm`; `linear`, `matmul` and `einsum` reach them), plus
    each kernel's formula (`kernels.cost`: flash attention's 2 (Dk + Dv)
    a kept pair and head, `pairwise_l2`'s 2 Q N D, ...).  Elementwise work
    counts nothing on either side: the Mamba2 conv is K shifted multiplies
    in both packages (no dot, no convolution), so neither counts it.  XLA
    may rewrite a dot whose contraction has size 1 into a multiply, which
    the reference then does not count while the port's bmm does;
  - `bytes`: the output bytes of every operation that materialises a
    tensor (`hlo_analysis.py:192-193`), plus each kernel's outputs.  Views,
    `detach`, aliases, in-place and `out=` operations and `empty`
    allocations add nothing, nor do the collectives (counted apart, as the
    reference's are).  XLA fuses elementwise chains into one output where
    eager PyTorch writes each step's, so on a whole model the port's bytes
    sit above the reference's (PERF.md gives the ratio on the SMOKE
    cells);
  - `coll_bytes` / `coll_counts`: by the reference's five classes
    (`hlo_analysis.COLLECTIVES`); the port's `all_gather`, `all_reduce`
    and `reduce_scatter` are three of them, `all-to-all` and
    `collective-permute` stay 0.  Bytes are a shard's operand bytes per
    call, as `hlo_analysis.py:181-186` counts them; a backward's
    collectives count where they run (their `.grad` sites).  A collective
    over a one-rank axis moves nothing but keeps its call and its bytes
    (the port's counted pattern is the same at any axis size);
  - the reference's `loops` (trip counts of while loops) has no
    counterpart: an eager run executes every iteration of a layer loop,
    a grad-accumulation loop or a chunked scan, so each is counted as it
    runs and nothing needs multiplying.

In place of `memory_analysis`, `CostMode` tracks the storages the program
allocates (an operation's output that aliases no input) and frees (a
finalizer on the storage): `temp_peak_bytes` is the most that was live at
once, `peak_bytes` that plus `arg_bytes`, the storages of the arguments
the caller names (the rank's parameters, optimizer state or cache, batch),
and `live_bytes` what was still held at the end (the outputs, and whatever
the program keeps).  On the card `temp_peak_bytes` stands beside the rise
of `torch.cuda.max_memory_allocated` over the same run (the caching
allocator rounds each block up to 512 bytes).
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import cost as kernel_cost

# the reference's collective classes (hlo_analysis.COLLECTIVES)
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_CLASS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "reduce_scatter": "reduce-scatter"}

_aten = torch.ops.aten
# allocations that write nothing (the reference's parameter / constant /
# iota: no traffic)
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default,
               _aten.new_empty_strided.default}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


_DOTS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm, _aten.addbmm, _aten.mv,
         _aten.addmv, _aten.dot, _aten.vdot}


def _dot_flops(func, args, out) -> float:
    """2 prod(result) prod(contracted) of a matmul-family op, else 0."""
    packet = func.overloadpacket
    if packet in (_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm, _aten.addbmm):
        a = args[1] if packet in (_aten.addmm, _aten.baddbmm, _aten.addbmm) else args[0]
        return 2.0 * _numel(out.shape) * a.shape[-1] * (
            a.shape[0] if packet is _aten.addbmm else 1)
    if packet in (_aten.mv, _aten.addmv):
        a = args[1] if packet is _aten.addmv else args[0]
        return 2.0 * _numel(out.shape) * a.shape[-1]
    if packet in (_aten.dot, _aten.vdot):
        return 2.0 * args[0].shape[0]
    return 0.0


@dataclasses.dataclass
class CostSummary:
    """The counts of one run (see the module's docstring)."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(COLLECTIVES,
                                                                               0.0))
    coll_counts: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(COLLECTIVES,
                                                                                0))
    aten_flops: float = 0.0       # the matmul family's share of `flops`
    aten_ops: int = 0             # aten operations seen
    kernels: dict = dataclasses.field(default_factory=dict)  # name -> launches, work
    arg_bytes: int = 0
    temp_peak_bytes: int = 0
    live_bytes: int = 0

    @property
    def peak_bytes(self) -> int:
        return self.arg_bytes + self.temp_peak_bytes

    def add_kernel(self, kernel: str, work: kernel_cost.Work) -> None:
        k = self.kernels.setdefault(kernel, {"launches": 0, "flops": 0.0, "bytes": 0.0,
                                             "out_bytes": 0.0})
        k["launches"] += 1
        k["flops"] += work.flops
        k["bytes"] += work.bytes
        k["out_bytes"] += work.out_bytes
        self.flops += work.flops
        self.bytes += work.out_bytes

    def add_collective(self, primitive: str, nbytes: int) -> None:
        cls = _CLASS[primitive]
        self.coll_bytes[cls] += float(nbytes)
        self.coll_counts[cls] += 1

    def record(self) -> dict:
        """The dry-run's fields, under the reference's key names."""
        return {"hlo": {"flops_per_device": self.flops, "hbm_bytes_per_device": self.bytes,
                        "collective_bytes_per_shard": dict(self.coll_bytes),
                        "collective_counts": dict(self.coll_counts)},
                "collective_bytes_per_shard_total": float(sum(self.coll_bytes.values())),
                "live_memory": {"argument_bytes": self.arg_bytes,
                                "temp_peak_bytes": self.temp_peak_bytes,
                                "peak_bytes": self.peak_bytes,
                                "live_bytes_at_end": self.live_bytes},
                "counted_ops": {"aten_ops": self.aten_ops, "aten_dot_flops": self.aten_flops,
                                "kernels": {k: dict(v) for k, v in self.kernels.items()}}}


def _storages(tree):
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            yield t.untyped_storage()


def _op_kind(func) -> tuple:
    """(counted, dot packet or None, writes its outputs) of an operator:
    counted is False outside aten (the collectives' c10d ops) and for a
    result that aliases an input (views, detach, in-place, out=)."""
    if func.namespace != "aten":
        return False, None, False
    if any(r.alias_info is not None for r in func._schema.returns):
        return None, func.overloadpacket, False
    return True, func.overloadpacket, func not in _NO_TRAFFIC


class CostMode(TorchDispatchMode):
    """Count a rank's program (the module's docstring): `with CostMode(args)
    as mode: step(...)`, then `mode.summary`.  `args` are the tensors the
    program is handed (nested dicts, lists and modules' parameters
    flattened by the caller), whose storages are the argument bytes; a
    storage the program allocates counts as live until it is freed."""

    def __init__(self, args=()):
        super().__init__()
        self.summary = CostSummary()
        seen = {}
        for s in _storages(args):
            seen[s._cdata] = s.nbytes()
        self.summary.arg_bytes = int(sum(seen.values()))
        self._live = 0
        self._tracked: dict = {}   # storage key -> (bytes, weak reference)
        self._kinds: dict = {}
        self._record = None

    def _freed(self, key: int) -> None:
        nbytes, _ = self._tracked.pop(key)
        self._live -= nbytes

    def __enter__(self):
        self._record = kernel_cost.open_record(self.summary)
        self._record.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._record.__exit__(*exc)
            self.summary.live_bytes = self._live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = _op_kind(func)
        counted, packet, writes = kind
        if counted is False:
            return out  # the collectives' c10d ops and other libraries: counted apart
        s = self.summary
        s.aten_ops += 1
        outs = (out,) if isinstance(out, torch.Tensor) else [
            t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if packet in _DOTS and outs:
            flops = _dot_flops(func, args, outs[0])
            s.aten_flops += flops
            s.flops += flops
        if counted is None:
            return out  # a view, an alias, an in-place or out= result
        for t in outs:
            if writes:
                s.bytes += float(t.numel() * t.element_size())
            st = t.untyped_storage()
            key = st._cdata
            if key in self._tracked:
                continue
            n = st.nbytes()
            self._tracked[key] = (n, weakref.ref(st, lambda _, key=key: self._freed(key)))
            self._live += n
            if self._live > s.temp_peak_bytes:
                s.temp_peak_bytes = self._live
        return out
