"""Device meshes of the LM launchers: counterpart of
``repro/launch/mesh.py``, on ``torch.distributed``'s ``DeviceMesh``.

Functions, not module constants, so importing this module opens no
process group. ``make_production_mesh`` lays the default process group
out as the reference's production mesh, (16, 16) ``("data", "model")``
or (2, 16, 16) ``("pod", "data", "model")``, and raises on a world of
another size. ``make_local_mesh`` is the (1, 1) mesh with the same axis
names: it opens a process group of world size 1 itself when none is open
(NCCL on the card, gloo on the CPU, over an in-memory store) and reuses
one that is already open, so a process may call it again. The mesh's
device type follows the caller's device.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["make_production_mesh", "make_local_mesh", "production_world",
           "DATA_AXES", "MODEL_AXIS"]

# batch / sequence shard over these; tensor/expert parallel over MODEL_AXIS
DATA_AXES = ("pod", "data")
MODEL_AXIS = "model"


def production_world(multi_pod: bool = False) -> int:
    """Ranks of the production mesh: 256, or 512 over two pods."""
    return 512 if multi_pod else 256


def _device_type(device: DeviceLike) -> str:
    return resolve_device(device).type


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    """The production mesh over the default process group, which must be
    open with 256 ranks (512 with ``multi_pod``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != production_world(multi_pod):
        raise RuntimeError(
            f"the {'multi-pod' if multi_pod else 'single-pod'} production "
            f"mesh {shape} needs a world of {production_world(multi_pod)} "
            f"ranks; this process group has {world}")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=axes)


def make_local_mesh(device: DeviceLike = None) -> DeviceMesh:
    """(1, 1) mesh with the production axis names, for one process. Opens
    a process group of world size 1 when none is open."""
    dev_type = _device_type(device)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev_type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    elif dist.get_world_size() != 1:
        raise RuntimeError(
            f"the local (1, 1) mesh is for one process; this process group "
            f"has {dist.get_world_size()} ranks")
    if dev_type == "cuda":
        torch.cuda.set_device(resolve_device(device))
    return init_device_mesh(dev_type, (1, 1),
                            mesh_dim_names=("data", "model"))
