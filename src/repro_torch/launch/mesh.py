"""Production meshes (the dry-run targets), the port of
``repro/launch/mesh.py``:

single-pod: (16, 16) = 256 ranks, axes (data, model)
multi-pod : (2, 16, 16) = 512 ranks, axes (pod, data, model)

Functions, never module-level constants: a mesh needs an initialised
``torch.distributed`` world of exactly that many ranks, one a GPU.
"""
from __future__ import annotations

import math

import torch.distributed as dist


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production DeviceMesh over the initialised world; raises, naming
    the shape, unless the world has exactly its 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != math.prod(shape):
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs a world of "
            f"{math.prod(shape)} ranks, have {world}")
    from repro_torch.distributed.mesh import make_test_mesh
    return make_test_mesh(dict(zip(axes, shape)), device=device)


def data_axes(multi_pod: bool = False) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)
