"""Launcher of the CUDA kernel ``assign_fused`` (``csrc/assign.cu``).

The port of ``assign_fused_pallas`` (``repro/kernels/assign.py:146``): for
each block of 128 rows, one CTA loops over all landmark tiles, builds each
Gram tile on chip, contracts it at once against the normalized one-hot H
into an f accumulator that stays in shared memory, and after the last tile
writes f, min_j (g_j - 2 f_ij) and its argmin (lowest index on ties). The
[rows, landmarks] Gram block never reaches device memory. ``ops.assign_fused``
and ``ops.gram_matvec`` are the wrappers callers use; this module only
checks operands and launches.
"""
from __future__ import annotations

import torch

from . import build
from .kernel_matrix import KINDS, VEC

#: cluster columns per contraction chunk: Cp must be a multiple of it
CP_MULTIPLE = 16
#: the f accumulator [128, Cp] f32 must fit in shared memory beside the
#: tile; ``ops`` launches once per chunk of this many clusters
MAX_CP = 256
_ENTRY = {torch.float32: "rt_assign_fused_f32",
          torch.bfloat16: "rt_assign_fused_bf16"}


def assign_fused_cuda(x: torch.Tensor, landmarks: torch.Tensor,
                      xsq: torch.Tensor, lsq: torch.Tensor, h: torch.Tensor,
                      g: torch.Tensor, *, kind: str, gamma: float,
                      coef0: float, degree: int):
    """x [M, D], landmarks [L, D] in f32 or bf16 (D a multiple of ``VEC``);
    xsq [M], lsq [L], h [L, Cp], g [Cp] f32, Cp a multiple of
    ``CP_MULTIPLE`` and at most ``MAX_CP``.
    Returns (labels [M] int32, mind [M] f32, f [M, Cp] f32)."""
    if kind not in KINDS:
        raise ValueError(f"assign_fused has no epilogue for {kind!r}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"assign_fused takes f32 or bf16 tiles, got {x.dtype}")
    m, d = x.shape
    lm, cp = h.shape
    if d % VEC[x.dtype]:
        raise ValueError(f"D={d} must be a multiple of {VEC[x.dtype]}")
    if cp % CP_MULTIPLE or not 0 < cp <= MAX_CP:
        raise ValueError(
            f"Cp={cp} must be a positive multiple of {CP_MULTIPLE} and at "
            f"most {MAX_CP} (the on-chip f accumulator holds {MAX_CP} "
            f"clusters; ops.assign_fused launches once per {MAX_CP})")
    dev = x.device
    build.check_operand(x, "x", dtype=x.dtype, shape=(m, d), device=dev)
    build.check_operand(landmarks, "landmarks", dtype=x.dtype, shape=(lm, d),
                        device=dev)
    build.check_operand(xsq, "xsq", dtype=torch.float32, shape=(m,), device=dev)
    build.check_operand(lsq, "lsq", dtype=torch.float32, shape=(lm,), device=dev)
    build.check_operand(h, "h", dtype=torch.float32, shape=(lm, cp), device=dev)
    build.check_operand(g, "g", dtype=torch.float32, shape=(cp,), device=dev)
    labels = torch.empty((m,), dtype=torch.int32, device=dev)
    mind = torch.empty((m,), dtype=torch.float32, device=dev)
    f = torch.empty((m, cp), dtype=torch.float32, device=dev)
    build.launch(_ENTRY[x.dtype], x.data_ptr(), landmarks.data_ptr(),
                 xsq.data_ptr(), lsq.data_ptr(), h.data_ptr(), g.data_ptr(),
                 labels.data_ptr(), mind.data_ptr(), f.data_ptr(), m, lm, d,
                 cp, KINDS[kind], float(gamma), float(coef0), int(degree))
    return labels, mind, f
