"""Public wrappers of the two kernels: ``kernel_matrix``, ``assign_fused``
and ``gram_matvec`` (the port of ``repro/kernels/ops.py:98-192``).

Each wrapper casts the tile operands to the policy's tile dtype ONCE at
entry and computes the squared norms FROM the cast values, so kernel and
plain version see identical inputs. ``assign_fused`` builds H as
one-hot(labels)/counts and puts +1e30 on empty clusters.

Dispatch is by device, and only by device: a CPU tensor runs the plain
PyTorch version (``kernels/ref.py``); a CUDA tensor launches the hand-written
kernel or raises — there is no fallback. On the card the wrappers split the
cluster axis into chunks of at most 256 (one launch each, merged by lowest
index), pad each to the kernel's multiple of 16 (zero columns of H, +1e30
in g; padded clusters can never be chosen), pad D with zero features up to the
16-byte vector width when needed, and slice the results back. The kernels
mask ragged rows and landmarks themselves, and zero the Gram columns of
landmarks past L, so landmark padding never reaches f. Block shapes are the
kernels' own (``csrc/gram_tile.cuh``), chosen for Hopper's shared memory and
registers — nothing here is a TPU tiling.

``LAUNCHES`` counts kernel launches per kernel (plain integers, reset by the
caller), so a run on the card can show that its main path went through the
kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ref
from .assign import CP_MULTIPLE, MAX_CP, assign_fused_cuda
from .kernel_matrix import VEC, kernel_matrix_cuda
from .precision import resolve_precision

BIG = 1e30   # "+inf" of empty and padded clusters that survives min/argmin

#: launches of each CUDA kernel
LAUNCHES = {"kernel_matrix": 0, "assign_fused": 0}


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _sqnorms(a: torch.Tensor) -> torch.Tensor:
    return torch.sum(a.to(torch.float32) ** 2, dim=1)


def _operand(a: torch.Tensor) -> torch.Tensor:
    """Contiguous, 16-byte aligned, D zero-padded to the vector width."""
    d = a.shape[1]
    dp = _round_up(d, VEC[a.dtype])
    if dp != d:
        a = F.pad(a, (0, dp - d))
    a = a.contiguous()
    return a if a.data_ptr() % 16 == 0 else a.clone()


def kernel_matrix(x: torch.Tensor, y: torch.Tensor, *, kind: str = "rbf",
                  gamma: float = 1.0, coef0: float = 1.0, degree: int = 3,
                  precision: str = "f32") -> torch.Tensor:
    """K(X, Y) -> [m, n] f32."""
    p = resolve_precision(precision)
    x, y = p.cast_tiles(x), p.cast_tiles(y)
    if not x.is_cuda:
        return ref.kernel_matrix_ref(x, y, kind=kind, gamma=gamma,
                                     coef0=coef0, degree=degree,
                                     precision=p.tile)
    out = kernel_matrix_cuda(_operand(x), _operand(y), _sqnorms(x),
                             _sqnorms(y), kind=kind, gamma=gamma,
                             coef0=coef0, degree=degree)
    LAUNCHES["kernel_matrix"] += 1
    return out


def _launch_assign(x, landmarks, h, g, *, kind, gamma, coef0, degree):
    """Launch once per chunk of at most ``MAX_CP`` clusters (the kernel's
    on-chip f accumulator), each padded to the kernel's multiple (zero H
    columns, +1e30 in g), and return (labels, mind, f [n, C]).

    Each f column, and so each g_j - 2 f_ij, comes out the same whatever
    the chunking. The merge takes a later chunk only where it is strictly
    smaller, so the lowest cluster index still wins ties. Past 256 clusters
    every chunk rebuilds the Gram tiles."""
    xo, lo = _operand(x), _operand(landmarks)
    xsq, lsq = _sqnorms(x), _sqnorms(landmarks)
    labels = mind = None
    fs = []
    for c0 in range(0, h.shape[1], MAX_CP):
        hc, gc = h[:, c0:c0 + MAX_CP], g[c0:c0 + MAX_CP]
        c = hc.shape[1]
        cp = _round_up(c, CP_MULTIPLE)
        lab, mn, f = assign_fused_cuda(
            xo, lo, xsq, lsq, F.pad(hc, (0, cp - c)).contiguous(),
            F.pad(gc, (0, cp - c), value=BIG).contiguous(), kind=kind,
            gamma=gamma, coef0=coef0, degree=degree)
        LAUNCHES["assign_fused"] += 1
        fs.append(f[:, :c])
        if labels is None:
            labels, mind = lab, mn
        else:
            better = mn < mind
            labels = torch.where(better, lab + c0, labels)
            mind = torch.where(better, mn, mind)
    return labels, mind, fs[0] if len(fs) == 1 else torch.cat(fs, dim=1)


def assign_panels(labels_l: torch.Tensor, counts: torch.Tensor,
                  g: torch.Tensor, n_clusters: int):
    """The cluster operands of the fused assignment, the same for kernel and
    plain version: (H [L, C] = one-hot(labels_l) / counts, g [C] f32 with
    +1e30 on empty clusters)."""
    counts = counts.to(torch.float32)
    h = F.one_hot(labels_l.long(), n_clusters).to(torch.float32)
    h = h / torch.clamp(counts, min=1.0)[None, :]
    gm = torch.where(counts > 0, g.to(torch.float32),
                     torch.full_like(counts, BIG))
    return h, gm


def assign_fused(x: torch.Tensor, landmarks: torch.Tensor,
                 labels_l: torch.Tensor, counts: torch.Tensor,
                 g: torch.Tensor, *, n_clusters: int, kind: str = "rbf",
                 gamma: float = 1.0, coef0: float = 1.0, degree: int = 3,
                 precision: str = "f32"):
    """Fused Eq.15/17: (labels [n] int32, mind [n] f32, f [n, C] f32) with
    f = K(x, landmarks) @ H, H = one-hot(labels_l) / counts, and
    labels/mind = argmin/min_j (g_j - 2 f_ij), empty clusters at +1e30."""
    p = resolve_precision(precision)
    x, landmarks = p.cast_tiles(x), p.cast_tiles(landmarks)
    h, gm = assign_panels(labels_l, counts, g, n_clusters)
    if not x.is_cuda:
        return ref.assign_fused_ref(x, landmarks, h, gm, kind=kind,
                                    gamma=gamma, coef0=coef0, degree=degree,
                                    precision=p.tile)
    return _launch_assign(x, landmarks, h, gm, kind=kind, gamma=gamma,
                          coef0=coef0, degree=degree)


def gram_matvec(x: torch.Tensor, landmarks: torch.Tensor, h: torch.Tensor, *,
                kind: str = "rbf", gamma: float = 1.0, coef0: float = 1.0,
                degree: int = 3, precision: str = "f32") -> torch.Tensor:
    """K(x, landmarks) @ h -> [n, C] f32 for any [L, C] panel h, without
    the [n, L] block in device memory: the fused assignment kernel with
    g = 0, whose argmin outputs are dropped."""
    p = resolve_precision(precision)
    x, landmarks = p.cast_tiles(x), p.cast_tiles(landmarks)
    h = h.to(torch.float32)
    if not x.is_cuda:
        return ref.kernel_matrix_ref(x, landmarks, kind=kind, gamma=gamma,
                                     coef0=coef0, degree=degree,
                                     precision=p.tile) @ h
    zeros = torch.zeros(h.shape[1], dtype=torch.float32, device=h.device)
    return _launch_assign(x, landmarks, h, zeros, kind=kind, gamma=gamma,
                          coef0=coef0, degree=degree)[2]
