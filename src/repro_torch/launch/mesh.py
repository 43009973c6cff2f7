"""Production meshes (the dry-run targets), the port of
``repro/launch/mesh.py``:

single-pod: (16, 16) = 256 ranks, axes (data, model)
multi-pod : (2, 16, 16) = 512 ranks, axes (pod, data, model)

Functions, never module-level constants: a mesh needs an initialised
``torch.distributed`` world of exactly that many ranks, one a GPU.

``join_torchrun`` and ``launcher_mesh`` give ``launch.train`` and
``launch.serve`` their ``--mesh DxM``: the (data, model) mesh of the
world the launcher runs in.
"""
from __future__ import annotations

import math
import os

import torch
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
    """The data axes of the production mesh (``distributed.mesh.DATA_AXES``
    that it has)."""
    from repro_torch.distributed.mesh import DATA_AXES
    return DATA_AXES if multi_pod else DATA_AXES[1:]


def join_torchrun(dev: torch.device) -> bool:
    """Join the world torchrun describes (NCCL on the card, gloo on the
    CPU), unless one is up or none is described; True when this call
    joined it."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://", **kw)
    return True


def launcher_mesh(spec: str, dev: torch.device):
    """``--mesh DxM`` -> the (data D, model M) DeviceMesh of the
    initialised world, or None for 1x1 with no world up (one process)."""
    dims = tuple(int(v) for v in spec.lower().split("x"))
    if len(dims) != 2 or min(dims) < 1:
        raise ValueError(f"--mesh takes DxM, got {spec!r}")
    if dims == (1, 1) and not dist.is_initialized():
        return None
    if not dist.is_initialized():
        raise RuntimeError(f"--mesh {spec} needs a torch.distributed world "
                           f"of {math.prod(dims)} ranks (run under torchrun)")
    if dist.get_world_size() != math.prod(dims):
        raise ValueError(f"--mesh {spec} has {math.prod(dims)} ranks, the "
                         f"world has {dist.get_world_size()}")
    from repro_torch.distributed.mesh import make_test_mesh
    return make_test_mesh({"data": dims[0], "model": dims[1]},
                          device=dev.type)
