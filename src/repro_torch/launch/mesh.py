"""Device meshes over a `torch.distributed` world (port of
`repro.launch.mesh`).

A mesh is `torch.distributed.device_mesh.DeviceMesh` with named axes, the
counterpart of `jax.make_mesh(shape, names)`: one rank a device, one
process a rank (`torchrun --nproc-per-node P`).  The serving meshes are
(data, model) = (1, P): the catalog and the cache state shard over
`model`, requests over `data`.

The world is the caller's: every function here takes an initialised
default process group (gloo for a "cpu" mesh, NCCL for a "cuda" one) and
none touches process-group state at import.  The one exception is
`fake_world`, which opens a world with no peers (the fake backend): one
rank of a mesh of any size, whose collectives move nothing, for the
dry-run's meta tensors (`launch.dryrun`) and for them only.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core.distributed import FAKE_BACKEND

SERVING_AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def _world(device_type: str) -> int:
    if not dist.is_initialized():
        raise ValueError(
            "no torch.distributed world: call torch.distributed.init_process_group "
            "(gloo for a cpu mesh, nccl for a cuda one) or run under torchrun first")
    backend = dist.get_backend()
    if backend == FAKE_BACKEND:  # a world-less mesh (meta tensors only)
        return dist.get_world_size()
    want = "nccl" if device_type == "cuda" else "gloo"
    if want not in backend:
        raise ValueError(f"a {device_type} mesh needs a {want} process group; the world's "
                         f"backend is {backend!r}")
    return dist.get_world_size()


def make_mesh(shape, axis_names=SERVING_AXES, device_type: str = "cpu"):
    """A DeviceMesh of `shape` over the whole world, axes named
    `axis_names`; the world's size must equal the mesh's."""
    shape = tuple(int(s) for s in shape)
    world = _world(device_type)
    size = 1
    for s in shape:
        size *= s
    if size != world:
        raise ValueError(f"a {shape} mesh needs a world of {size} ranks; this one has "
                         f"{world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


def production_mesh_shape(multi_pod: bool = False) -> dict:
    """The reference's production layout as {axis: ranks}: (data 16, model
    16), or (pod 2, data 16, model 16) across pods (the dry-run's meshes;
    no world needed)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production layout's mesh: a world of 256 (512) ranks."""
    shape = production_mesh_shape(multi_pod)
    return make_mesh(tuple(shape.values()), tuple(shape), device_type)


def fake_backend_source() -> str:
    """Register the fake backend (`FAKE_BACKEND`) and say whose it is:
    PyTorch's own (`torch.testing._internal.distributed.fake_pg`, which
    registers it on import), else the C++ `FakeProcessGroup` registered
    here under the same name.  Raises where this PyTorch has neither."""
    try:
        import torch.testing._internal.distributed.fake_pg  # noqa: F401  (registers it)

        return "torch.testing._internal.distributed.fake_pg"
    except ImportError:
        pass
    from torch._C._distributed_c10d import FakeProcessGroup

    if FAKE_BACKEND not in dist.Backend.backend_list:
        dist.Backend.register_backend(
            FAKE_BACKEND, lambda store, rank, size, timeout: FakeProcessGroup(rank, size),
            devices=["cpu", "cuda"])
    return "torch._C._distributed_c10d.FakeProcessGroup (registered by repro_torch)"


def fake_world(world_size: int, rank: int = 0) -> str:
    """Open a world of `world_size` ranks in which this process is `rank`
    and no other process exists: the fake backend's groups send nothing,
    so a mesh over it lays out one rank of a production mesh with no
    world and no card, for meta tensors only (`core.distributed._group`
    refuses CPU and CUDA tensors on it).  The world is the process's:
    open it in a process of its own (the dry-run's CLI, a spawned test
    worker) and close it with `torch.distributed.destroy_process_group`.
    Returns `fake_backend_source()`."""
    source = fake_backend_source()
    if dist.is_initialized():
        raise ValueError("a torch.distributed world is open already; a fake world needs "
                         "a process of its own")
    dist.init_process_group(FAKE_BACKEND, store=dist.HashStore(), rank=rank,
                            world_size=world_size)
    return source


def make_host_mesh(device_type: str = "cpu"):
    """The (1, 1) mesh of a one-rank world (the tests' and the card's
    single-device mesh)."""
    return make_mesh((1, 1), SERVING_AXES, device_type)


def mesh_shape_dict(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_axes(multi_pod: bool) -> tuple:
    return ("pod", "data") if multi_pod else ("data",)
