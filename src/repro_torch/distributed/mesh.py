"""Mesh utilities of the distributed clustering runtime, the port of
``repro/distributed/mesh.py``.

The reference runs SPMD inside one process through ``shard_map``; the port
runs SPMD across processes. Every rank of an initialised
``torch.distributed`` world runs the same host loop, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with dim names ``("data",
"model")`` or ``("pod", "data", "model")``. Its device type follows the
tensors: ``cuda`` over NCCL on the card, ``cpu`` over gloo (the tests'
spawned worlds). The production meshes live in ``launch/mesh.py``.

The collectives go through ``all_gather`` and ``all_reduce`` here, which
call ``torch.distributed.all_gather_into_tensor`` / ``all_reduce`` on the
group of one or more mesh axes (``axis_group``), so a wrapper around those
two functions of ``torch.distributed`` counts every collective of the
clustering runtime. The expert-parallel MoE exchanges tokens through
``all_to_all`` (one ``all_to_all_single``, differentiable). ``tally()``
counts them from inside: while it is open, every call of the three, and
the bytes each ``all_reduce`` sums, add to its ``CollectiveTally`` (the
flight recorder's measured collective bill).

The model axis (Megatron-style tensor parallelism of the LM families) has
its own differentiable collectives, each over one axis (``"model"`` by
default) and each the identity, launching nothing, on an axis of one rank:

  copy_to_model      identity forward, all_reduce backward
  reduce_from_model  all_reduce forward, identity backward
  all_gather_dim     all_gather along a dim, reduce_scatter backward
  reduce_scatter     reduce_scatter along a dim, all_gather backward
  split_to_model     this rank's block of a replicated tensor forward,
                     all_gather backward
  gather_from_model  all_gather forward into a replicated tensor, this
                     rank's block backward

and ``all_reduce_max`` (no gradient). They count in the tally forward and
backward alike: ``psum`` / ``psum_bytes`` for the all_reduces,
``allgather`` / ``allgather_bytes`` for the all_gathers (the bytes
returned), ``reducescatter`` / ``reducescatter_bytes`` for the
reduce_scatters (the bytes sent in).
"""
from __future__ import annotations

import contextlib
import math
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def make_test_mesh(axes: dict[str, int] | None = None, device=None):
    """A DeviceMesh over the initialised world; the default splits it into
    (data, model) with the largest power-of-two model axis <= sqrt(n).
    ``device`` names the mesh's device type (``None``: the card)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            "make_test_mesh needs an initialised torch.distributed world "
            "(init_process_group with its rank and world size)")
    n = dist.get_world_size()
    if axes is None:
        model = 1
        while model * 2 <= int(math.isqrt(n)) and n % (model * 2) == 0:
            model *= 2
        axes = {"data": n // model, "model": model}
    shape = tuple(int(v) for v in axes.values())
    if math.prod(shape) != n:
        raise ValueError(f"mesh {axes} needs {math.prod(shape)} devices, "
                         f"have {n}")
    dev = resolve_device(device)
    return init_device_mesh(dev.type, shape, mesh_dim_names=tuple(axes))


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh, in mesh order."""
    return {name: int(mesh.size(i))
            for i, name in enumerate(mesh.mesh_dim_names)}


#: the axes a batch splits over, outermost first; a mesh has those of them
#: it names (the multi-pod production mesh both)
DATA_AXES = ("pod", "data")


def data_axes(mesh) -> tuple[tuple[str, ...], int]:
    """The data axes ``mesh`` has (of ``DATA_AXES``) and the number of
    ranks along them."""
    shape = mesh_shape(mesh)
    axes = tuple(a for a in DATA_AXES if a in shape)
    return axes, math.prod(shape[a] for a in axes)


def axis_size(mesh, names: tuple[str, ...] | str) -> int:
    if isinstance(names, str):
        names = (names,)
    shape = mesh_shape(mesh)
    out = 1
    for n in names:
        out *= shape[n]
    return out


def row_axes_of(mesh) -> tuple[str, ...]:
    """Row (data-parallel) axes: every mesh axis except 'model'."""
    return tuple(n for n in mesh.mesh_dim_names if n != "model")


def ghost_row_ids(n: int, multiple: int) -> np.ndarray:
    """Source row ids for the ghost rows that pad an n-row batch up to a
    ``multiple`` of the mesh row count: head rows repeated modulo n, so a
    tail batch SMALLER than the mesh (a stream's last yield) pads correctly
    instead of indexing past the batch. Shared by the dense, CSR and exact
    staging paths."""
    if n < 1:
        raise ValueError("cannot stage an empty batch onto the mesh")
    return np.arange((-n) % multiple) % n


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on for ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_group(mesh, axes: tuple[str, ...] | str):
    """The process group of this rank over the mesh axes ``axes`` (in mesh
    order): one axis is the mesh's own group; several are built once per
    mesh, by every rank in the same order. Group rank i is the i-th of
    those ranks in row-major order over ``axes``, which is the order
    ``all_gather`` concatenates."""
    if isinstance(axes, str):
        axes = (axes,)
    names = tuple(mesh.mesh_dim_names)
    if list(axes) != [a for a in names if a in axes]:
        raise ValueError(f"axes {axes} are not in mesh order {names}")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_axis_groups", {})
    if axes not in cache:
        keep = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in keep]
        ranks = mesh.mesh.permute(*rest, *keep).reshape(
            -1, math.prod(mesh.mesh.shape[i] for i in keep))
        cache[axes], _ = dist.new_subgroups_by_enumeration(ranks.tolist())
    return cache[axes]


def axis_rank(mesh, axes: tuple[str, ...] | str) -> int:
    """This rank's position along ``axes`` (row-major over them)."""
    return dist.get_rank(axis_group(mesh, axes))


def _counter(kind: str, nbytes: bool = False) -> property:
    """A tally counter read from its ``calls``: the calls of ``kind``, or
    their bytes (a reduce_scatter's are the bytes it sent in: its
    output's times its group's size)."""
    def read(self) -> int:
        if not nbytes:
            return sum(1 for k, _, _ in self.calls if k == kind)
        return sum(b * n if kind == "reduce-scatter" else b
                   for k, b, n in self.calls if k == kind)
    return property(read)


class CollectiveTally:
    """Collectives through this module while a ``tally()`` is open.
    ``calls`` is the one record: every call as (the reference's HLO kind,
    its output's bytes, its group's size), what the reference's ring
    formulas price (``launch.dryrun.ring_bytes``). The counters under the
    reference's names are read from it: ``psum`` / ``psum_bytes`` (the
    all_reduce calls and the bytes they summed, per rank), ``allgather``
    / ``allgather_bytes`` (the bytes returned), ``alltoall`` /
    ``alltoall_bytes`` (the bytes each sent, which it also gets back) and
    ``reducescatter`` / ``reducescatter_bytes`` (the bytes each sent
    in)."""

    psum = _counter("all-reduce")
    psum_bytes = _counter("all-reduce", nbytes=True)
    allgather = _counter("all-gather")
    allgather_bytes = _counter("all-gather", nbytes=True)
    alltoall = _counter("all-to-all")
    alltoall_bytes = _counter("all-to-all", nbytes=True)
    reducescatter = _counter("reduce-scatter")
    reducescatter_bytes = _counter("reduce-scatter", nbytes=True)

    def __init__(self):
        self.calls: list[tuple[str, int, int]] = []

    def summary(self) -> dict:
        """Every counter by its name."""
        return {k: getattr(self, k) for k, v in vars(CollectiveTally).items()
                if isinstance(v, property)}


def _record(kind: str, nbytes: int, group_size: int) -> None:
    """Add one call to every open tally."""
    for c in _TALLIES:
        c.calls.append((kind, nbytes, group_size))


_TALLIES: list[CollectiveTally] = []


@contextlib.contextmanager
def tally():
    """Count this rank's collectives while the block runs."""
    t = CollectiveTally()
    _TALLIES.append(t)
    try:
        yield t
    finally:
        _TALLIES.remove(t)


def all_gather(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Concatenate ``t`` of every rank along ``axes`` on dim 0: ONE
    ``all_gather_into_tensor`` (torch 2.13 names it deprecated; it is the
    call both 2.11 and 2.13 have)."""
    group = axis_group(mesh, axes)
    t = t.contiguous()
    out = torch.empty((dist.get_world_size(group) * t.shape[0],
                       *t.shape[1:]), dtype=t.dtype, device=t.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, t, group=group)
    _record("all-gather", out.numel() * out.element_size(),
            dist.get_world_size(group))
    return out


def all_reduce(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum ``t`` over the ranks along ``axes``: ONE ``all_reduce`` (in
    place on a contiguous copy; returns it)."""
    return _all_reduce(t, axis_group(mesh, axes))


def _all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    _record("all-reduce", t.numel() * t.element_size(),
            dist.get_world_size(group))
    return t


def all_to_all(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Split ``t`` on dim 0 into one equal block per rank along ``axes``
    and send block j to rank j; returns the blocks received, in rank
    order, in ``t``'s shape: ONE ``all_to_all_single``, through
    ``torch.distributed.nn`` so that autograd carries gradients back by
    the reverse exchange (torch 2.13 names it deprecated; it is the
    autograd-aware call both 2.11 and 2.13 have). The tally counts the
    forward exchanges; the backward's run inside autograd."""
    from torch.distributed.nn.functional import all_to_all_single
    t = t.contiguous()
    group = axis_group(mesh, axes)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        out = all_to_all_single(torch.empty_like(t), t, group=group)
    _record("all-to-all", t.numel() * t.element_size(),
            dist.get_world_size(group))
    return out


# ---------------------------------------------------------------------------
# the model axis: differentiable collectives
# ---------------------------------------------------------------------------


def _gather_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """ONE all_gather of ``t`` along ``dim`` (rank order)."""
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x, group=group)
    _record("all-gather", out.numel() * out.element_size(), n)
    return out.movedim(0, dim)


def _scatter_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """ONE reduce_scatter of ``t`` along ``dim``: rank r gets block r of
    the sum over the ranks."""
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    if x.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {n} ranks")
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, x, group=group)
    _record("reduce-scatter", out.numel() * out.element_size(), n)
    return out.movedim(0, dim)


def _block(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {n} ranks")
    return t.chunk(n, dim=dim)[r].contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_dim(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_dim(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter_dim(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.group, ctx.dim), None, None


class _SplitToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.group, ctx.dim), None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_dim(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim), None, None


def _group_of(mesh, axes):
    """The axis group, or None on a missing mesh or an axis of one rank."""
    if mesh is None or axis_size(mesh, axes) == 1:
        return None
    return axis_group(mesh, axes)


def copy_to_model(t: torch.Tensor, mesh, axes="model") -> torch.Tensor:
    """A replicated tensor entering a model-parallel region: identity
    forward; backward sums the ranks' partial gradients (all_reduce)."""
    group = _group_of(mesh, axes)
    return t if group is None else _CopyToModel.apply(t, group)


def reduce_from_model(t: torch.Tensor, mesh, axes="model") -> torch.Tensor:
    """The ranks' partial sums made whole: all_reduce forward; the
    replicated gradient passes back unchanged."""
    group = _group_of(mesh, axes)
    return t if group is None else _ReduceFromModel.apply(t, group)


def all_gather_dim(t: torch.Tensor, mesh, dim: int,
                   axes="model") -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim``, inside a region whose
    gradients are partial: backward reduce_scatters them."""
    group = _group_of(mesh, axes)
    return t if group is None else _AllGatherDim.apply(t, group, dim)


def reduce_scatter(t: torch.Tensor, mesh, dim: int,
                   axes="model") -> torch.Tensor:
    """Block r (along ``dim``) of the sum over the ranks; backward
    all_gathers the blocks' gradients."""
    group = _group_of(mesh, axes)
    return t if group is None else _ReduceScatter.apply(t, group, dim)


def split_to_model(t: torch.Tensor, mesh, dim: int,
                   axes="model") -> torch.Tensor:
    """This rank's block of a replicated tensor along ``dim``; backward
    all_gathers the blocks' gradients into the replicated one."""
    group = _group_of(mesh, axes)
    return t if group is None else _SplitToModel.apply(t, group, dim)


def gather_from_model(t: torch.Tensor, mesh, dim: int,
                      axes="model") -> torch.Tensor:
    """Every rank's block concatenated along ``dim`` into a replicated
    tensor; backward keeps this rank's block of the replicated
    gradient."""
    group = _group_of(mesh, axes)
    return t if group is None else _GatherFromModel.apply(t, group, dim)


def all_reduce_max(t: torch.Tensor, mesh, axes="model") -> torch.Tensor:
    """The elementwise maximum over the ranks (no gradient)."""
    group = _group_of(mesh, axes)
    return t if group is None else _all_reduce(t.detach(), group, "max")
