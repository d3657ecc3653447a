"""Production meshes, PyTorch port of ``repro.launch.mesh``: torch
``DeviceMesh``es over the default process group.

Functions, not module-level constants: importing this module touches no
process group.  The caller starts the group: one rank per card on a real
cluster, or a fake group of 256 / 512 ranks in one process
(``launch.dryrun``), the counterpart of the reference's
``--xla_force_host_platform_device_count=512``.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.sharding.rules import mesh_shape


def _mesh(shape, axes, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != need:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a default process group "
            f"of {need} ranks; the world size is {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 = 256 chips per pod; 2x16x16 = 512 chips across 2 pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(devices: int = 8, device_type: str = "cuda"):
    """Small mesh for multi-process tests (2 x devices/2)."""
    return _mesh((2, devices // 2), ("data", "model"), device_type)


def mesh_desc(mesh) -> str:
    return "x".join(f"{a}={n}" for a, n in mesh_shape(mesh).items())
