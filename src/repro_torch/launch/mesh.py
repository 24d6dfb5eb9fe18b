"""Mesh definitions (port of repro.launch.mesh) as DeviceMeshes.

Defined as functions, not module constants, so importing this module
touches no device and no process group: a mesh is built over the
current process group (`torch.distributed.init_process_group` first; a
fake-backend world for the dry-run), on the device type the caller names.
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: 16x16 = 256 ranks (data, model).
    Multi-pod: 2x16x16 = 512 ranks (pod, data, model)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(shape=None, axes=("data", "model"),
                   device_type: str = "cpu"):
    """Mesh over every rank of the process group (tests / examples)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if shape is None:
        shape = (1, n)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def data_axes(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
