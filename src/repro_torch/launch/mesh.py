"""Mesh builders on torch ``DeviceMesh``: the port's counterpart of
``repro.launch.mesh``.

Functions only: importing this module touches no process group. Both
builders need ``torch.distributed`` initialised (``torchrun``, or
``init_process_group`` with an address, a world size and a rank), one rank
per device. ``device_type`` is "cuda" unless the caller asks for "cpu" (the
tests, over gloo).
"""
from __future__ import annotations

import numpy as np


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``, over the first ranks of the world; raises when the
    world has fewer."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks but only {world} present — "
            "start one rank per device (torchrun --nproc-per-node ...)")
    return DeviceMesh(device_type, np.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_local_mesh(axes=("data", "model"), device_type="cuda"):
    """(1, world) (or (world,) for one axis) over the ranks that exist."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    shape = (1, world) if len(axes) == 2 else (world,)
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axes))
