"""The mesh context (port of `repro.sharding.ctx`).

Model code stays mesh-agnostic: a launcher opens `mesh_context(mesh,
batch_axes)` around a forward or a training step, and the layers look the
context up to run on the rank's blocks (`sharding/tp.py`).
The context is thread-local, nests, and restores the previous one on
exit.  Autograd runs a CUDA backward on threads of its own, so work that
a backward recomputes (a checkpointed unit) reopens the context of its
forward there (`reopened`).  `mesh` is the port's `DeviceMesh` (`repro_torch.launch.mesh`),
`batch_axes` the mesh axes that carry the batch, e.g. ("data",) or
("pod", "data").  With `global_batch` the context also knows whether the
batch splits over those axes or stays whole on every rank
(`batch_whole`, decided once by `sharding.specs.batch_whole`: long-context
decode's global batch 1); a whole batch's caches shard their sequence
over the batch axes instead (`models.init_cache`, the attention and MLA
decodes), and its MoE routes the rank's tokens as the unmeshed layer.

The reference's `annotate(x, axes)` has no counterpart: it only guides
XLA's SPMD partitioner, and in the port a rank holds its own shard by
construction (`convert.lm_params_block`, the data slice of a batch), so
there is nothing to annotate.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional

_STATE = threading.local()


class MeshContext(NamedTuple):
    mesh: object          # torch.distributed.device_mesh.DeviceMesh
    batch_axes: tuple     # mesh axes carrying the batch dim
    batch_whole: bool     # every rank holds the whole batch (`specs.batch_whole`)


def current() -> Optional[MeshContext]:
    """The innermost open context of this thread (its mesh and batch
    axes), else None."""
    return getattr(_STATE, "ctx", None)


def mesh_active() -> bool:
    return current() is not None


def reopened():
    """A context manager that opens, on whatever thread enters it later, the
    context open on this thread now (none: a no-op).  A checkpointed
    unit's recomputation runs where autograd runs the backward, on a CUDA
    device thread of its own that has no context: `model.forward` hands
    this to `torch.utils.checkpoint` so the recomputation runs the rank's
    layout as its forward did."""
    ctx = current()
    return contextlib.nullcontext() if ctx is None else _opened(ctx)


@contextlib.contextmanager
def _opened(ctx: MeshContext):
    prev = current()
    _STATE.ctx = ctx
    try:
        yield
    finally:
        _STATE.ctx = prev


def mesh_context(mesh, batch_axes, global_batch: int | None = None):
    """Open a context of `mesh` with the batch over `batch_axes` (a name or
    a tuple of names, each an axis of the mesh) for this thread.
    `global_batch` (None: the batch splits, each rank holding its slice)
    decides `batch_whole` by `specs.batch_whole` over the mesh's shape:
    where the axes do not divide it every rank holds the whole batch."""
    from repro_torch.launch.mesh import mesh_shape_dict
    from repro_torch.sharding.specs import batch_whole

    batch_axes = (batch_axes,) if isinstance(batch_axes, str) else tuple(batch_axes)
    missing = [a for a in batch_axes if a not in mesh.mesh_dim_names]
    if missing:
        raise ValueError(f"batch axes {missing} are not axes of the mesh "
                         f"{mesh.mesh_dim_names}")
    whole = (global_batch is not None
             and batch_whole(global_batch, mesh_shape_dict(mesh), batch_axes))
    return _opened(MeshContext(mesh, batch_axes, whole))
