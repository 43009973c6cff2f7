"""Launcher of the CUDA kernel ``sketch_assign`` (``csrc/sketch_assign.cu``).

The port of ``sketch_assign_pallas`` (``repro/kernels/sketch_assign.py:111``):
count-sketch each row, z_j = sum_{i: h_i = j} sign_i x_i, contract z with
the value panel V on chip and take min_j (csq_j - 2 (z V)_ij) and its
argmin. The TPU body built a masked one-hot tile for its matrix unit; the
CUDA kernel gathers each bucket's columns instead, from the bucket-sorted
tables of ``bucket_tables`` (built once per map), in a fixed order, so two
launches agree bitwise. ``ops.sketch_assign`` is the wrapper callers use;
this module builds the tables, checks operands and launches.
"""
from __future__ import annotations

import torch

from . import build
from .assign import CP_MULTIPLE, MAX_CP

#: x tile dtype -> (entry, sign-table dtype): int8 signs under bf16
_ENTRY = {torch.float32: ("rt_sketch_assign_f32", torch.float32),
          torch.bfloat16: ("rt_sketch_assign_bf16", torch.int8)}


def bucket_tables(h: torch.Tensor, sign: torch.Tensor, m: int):
    """Sort the input columns by bucket: (order [D] int32, offsets [m + 1]
    int32, sign [D] f32 in that order). Bucket j owns the columns
    ``order[offsets[j]:offsets[j + 1]]``, in increasing index order (the
    sort is stable); columns with h = -1 sort before ``offsets[0]``."""
    hs, order = torch.sort(h.to(torch.int64), stable=True)
    offsets = torch.searchsorted(
        hs, torch.arange(m + 1, dtype=torch.int64, device=h.device))
    return (order.to(torch.int32).contiguous(),
            offsets.to(torch.int32).contiguous(),
            sign.to(torch.float32)[order].contiguous())


def sign_matrix(h: torch.Tensor, sign: torch.Tensor, m: int) -> torch.Tensor:
    """The count sketch as a [D, m] f32 matrix: row i holds sign_i in column
    h_i, and no entry where h_i = -1, so that z = x @ S."""
    d = h.shape[0]
    s = torch.zeros((d, m + 1), dtype=torch.float32, device=h.device)
    s[torch.arange(d, device=h.device), h.long() % (m + 1)] = \
        sign.to(torch.float32)                    # h = -1 -> column m, dropped
    return s[:, :m].contiguous()


def sketch_assign_cuda(x: torch.Tensor, order: torch.Tensor,
                       offsets: torch.Tensor, sign: torch.Tensor,
                       v: torch.Tensor, csq: torch.Tensor):
    """x [n, D] f32 or bf16; order [D], offsets [M + 1] int32 and sign [D]
    (f32 with f32 rows, int8 with bf16 rows) from ``bucket_tables``;
    v [M, Cp], csq [Cp] f32, Cp a multiple of ``CP_MULTIPLE`` and at most
    ``MAX_CP``. Returns (labels [n] int32, score [n] f32)."""
    if x.dtype not in _ENTRY:
        raise TypeError(f"sketch_assign takes f32 or bf16 rows, got {x.dtype}")
    entry, sign_dtype = _ENTRY[x.dtype]
    n, d = x.shape
    m, cp = v.shape
    if cp % CP_MULTIPLE or not 0 < cp <= MAX_CP:
        raise ValueError(
            f"Cp={cp} must be a positive multiple of {CP_MULTIPLE} and at "
            f"most {MAX_CP} (the on-chip F accumulator holds {MAX_CP} "
            f"clusters; ops.sketch_assign launches once per {MAX_CP})")
    dev = x.device
    build.check_operand(x, "x", dtype=x.dtype, shape=(n, d), device=dev)
    build.check_operand(order, "order", dtype=torch.int32, shape=(d,),
                        device=dev)
    build.check_operand(offsets, "offsets", dtype=torch.int32, shape=(m + 1,),
                        device=dev)
    build.check_operand(sign, "sign", dtype=sign_dtype, shape=(d,), device=dev)
    build.check_operand(v, "v", dtype=torch.float32, shape=(m, cp), device=dev)
    build.check_operand(csq, "csq", dtype=torch.float32, shape=(cp,), device=dev)
    labels = torch.empty((n,), dtype=torch.int32, device=dev)
    score = torch.empty((n,), dtype=torch.float32, device=dev)
    build.launch(entry, x.data_ptr(), order.data_ptr(), offsets.data_ptr(),
                 sign.data_ptr(), v.data_ptr(), csq.data_ptr(),
                 labels.data_ptr(), score.data_ptr(), n, d, m, cp)
    return labels, score
