"""Launcher of the CUDA kernel ``kernel_matrix`` (``csrc/kernel_matrix.cu``).

The port of ``kernel_matrix_pallas`` (``repro/kernels/kernel_matrix.py:78``):
K(X, Y) [M, N] f32 with f32 accumulation and the Mercer epilogue for rbf,
polynomial, cosine or linear. The source's header says what bounds it on
an H100 and how its tiles are laid out. ``ops.kernel_matrix`` is the
wrapper callers use; this module only checks operands and launches.
"""
from __future__ import annotations

import torch

from . import build

#: epilogue codes of ``gram_tile.cuh``'s ``Kind``
KINDS = {"linear": 0, "polynomial": 1, "cosine": 2, "rbf": 3}
#: features per 16-byte vector load: D must be a multiple of it
VEC = {torch.float32: 4, torch.bfloat16: 8}
_ENTRY = {torch.float32: "rt_kernel_matrix_f32",
          torch.bfloat16: "rt_kernel_matrix_bf16"}


def kernel_matrix_cuda(x: torch.Tensor, y: torch.Tensor, xsq: torch.Tensor,
                       ysq: torch.Tensor, *, kind: str, gamma: float,
                       coef0: float, degree: int) -> torch.Tensor:
    """x [M, D], y [N, D] in f32 or bf16 (D a multiple of ``VEC``);
    xsq [M], ysq [N] f32 squared norms of the same values -> [M, N] f32."""
    if kind not in KINDS:
        raise ValueError(f"kernel_matrix has no epilogue for {kind!r}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"kernel_matrix takes f32 or bf16 tiles, got {x.dtype}")
    m, d = x.shape
    n = y.shape[0]
    if d % VEC[x.dtype]:
        raise ValueError(f"D={d} must be a multiple of {VEC[x.dtype]}")
    dev = x.device
    build.check_operand(x, "x", dtype=x.dtype, shape=(m, d), device=dev)
    build.check_operand(y, "y", dtype=x.dtype, shape=(n, d), device=dev)
    build.check_operand(xsq, "xsq", dtype=torch.float32, shape=(m,), device=dev)
    build.check_operand(ysq, "ysq", dtype=torch.float32, shape=(n,), device=dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    build.launch(_ENTRY[x.dtype], x.data_ptr(), y.data_ptr(), xsq.data_ptr(),
                 ysq.data_ptr(), out.data_ptr(), m, n, d, KINDS[kind],
                 float(gamma), float(coef0), int(degree))
    return out
