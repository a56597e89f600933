"""Device meshes over a `torch.distributed` world (port of
`repro.launch.mesh`).

A mesh is `torch.distributed.device_mesh.DeviceMesh` with named axes, the
counterpart of `jax.make_mesh(shape, names)`: one rank a device, one
process a rank (`torchrun --nproc-per-node P`).  The serving meshes are
(data, model) = (1, P): the catalog and the cache state shard over
`model`, requests over `data`.

The world is the caller's: every function here takes an initialised
default process group (gloo for a "cpu" mesh, NCCL for a "cuda" one) and
none touches process-group state at import.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

SERVING_AXES = ("data", "model")


def _world(device_type: str) -> int:
    if not dist.is_initialized():
        raise ValueError(
            "no torch.distributed world: call torch.distributed.init_process_group "
            "(gloo for a cpu mesh, nccl for a cuda one) or run under torchrun first")
    backend = dist.get_backend()
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


def make_host_mesh(device_type: str = "cpu"):
    """The (1, 1) mesh of a one-rank world (the tests' and the card's
    single-device mesh)."""
    return make_mesh((1, 1), SERVING_AXES, device_type)


def mesh_shape_dict(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_axes(multi_pod: bool) -> tuple:
    return ("pod", "data") if multi_pod else ("data",)
