"""Launcher of the CUDA kernel ``embed_assign`` (``csrc/embed_assign.cu``).

The port of ``embed_assign_pallas`` (``repro/kernels/embed_assign.py:111``):
for each block of rows, a CTA loops over the embed tiles of the map panel
w, applies the random Fourier (``scale cos(x.w + b)``) or Mercer (Nystrom)
epilogue on chip, contracts the tile at once against the value panel V into
an on-chip F, and takes min_j (csq_j - 2 F_ij) and its argmin (lowest index
on ties). The embedded rows never reach device memory. The f32 body takes
its column tile and row block from ``f32_geometry``; the bf16 body is the
assign_fused bf16 body with the map as its epilogue (tiles of 128 x 128),
whose w axis splits over the grid as assign's landmark axis
(``assign.landmark_splits`` with ``assign.BF16``) into a scratch [splits,
n, Cp] that a second kernel sums in a fixed order (one split takes the
argmin in the body and needs no scratch). The Mercer kinds' launch
sums |x|^2 and |w|^2 itself, into a scratch of n + M. ``ops.embed_assign``
is the wrapper callers use; this module only checks operands, chooses the
split and launches.
"""
from __future__ import annotations

import torch

from . import build
from .assign import BF16, CP_MULTIPLE, MAX_CP, landmark_splits, occupancy
from .kernel_matrix import KINDS, VEC, _sm_count

#: epilogue codes: the Mercer kinds of ``kernel_matrix`` plus ``rff``
MAP_KINDS = {**KINDS, "rff": 4}
_ENTRY = {torch.float32: "rt_embed_assign_f32",
          torch.bfloat16: "rt_embed_assign_bf16"}
#: the f32 body's column tiles (widest first) and the row block built for
#: each: 80 rows give n = 60,000 (Fig.5) 750 CTAs, 95% of three whole waves
#: of 2 x 132, where 128 rows fill 89% of two
F32_GEOMETRY = {160: 80, 80: 80, 40: 128, 20: 128}


def padded_share(m: int, bn: int) -> float:
    """The share of a row's Gram work spent on padded columns when M = m
    is cut into tiles of bn columns."""
    cols = -(-m // bn) * bn
    return (cols - m) / cols


def f32_geometry(m: int) -> tuple[int, int]:
    """(column tile, row block) of the f32 body for an embedding of width
    m: the widest tile whose padded columns stay under 1/8 of the work,
    else the least padded one."""
    fits = [bn for bn in F32_GEOMETRY if padded_share(m, bn) < 1 / 8]
    bn = fits[0] if fits else min(F32_GEOMETRY,
                                  key=lambda t: padded_share(m, t))
    return bn, F32_GEOMETRY[bn]


def ctas_per_sm(cp: int, map_kind: str, index: int) -> int:
    """CTAs of the bf16 body (``map_kind``'s instantiation) one SM of card
    ``index`` holds at Cp clusters."""
    return occupancy("rt_embed_bf16_ctas_per_sm", cp, MAP_KINDS[map_kind],
                     index)


def embed_assign_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                      v: torch.Tensor, csq: torch.Tensor, *, map_kind: str,
                      gamma: float, coef0: float, degree: int, scale: float):
    """x [n, D], w [M, D] in f32 or bf16 (D a multiple of ``VEC``); b [M]
    f32, the phases, for rff and None for the Mercer kinds (whose launch
    sums the row norms itself); v [M, Cp] and csq [Cp] f32, Cp at most
    ``MAX_CP`` (at bf16 a multiple of ``CP_MULTIPLE``; the f32 body masks
    any count itself).
    Returns (labels [n] int32, score [n] f32)."""
    if map_kind not in MAP_KINDS:
        raise ValueError(f"embed_assign has no epilogue for {map_kind!r}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"embed_assign takes f32 or bf16 tiles, got {x.dtype}")
    n, d = x.shape
    m, cp = v.shape
    if d % VEC[x.dtype]:
        raise ValueError(f"D={d} must be a multiple of {VEC[x.dtype]}")
    multiple = 1 if x.dtype == torch.float32 else CP_MULTIPLE
    if cp % multiple or not 0 < cp <= MAX_CP:
        raise ValueError(
            f"Cp={cp} must be a positive multiple of {multiple} and at "
            f"most {MAX_CP} (the on-chip F accumulator holds {MAX_CP} "
            f"clusters; ops.embed_assign launches once per {MAX_CP})")
    if n == 0 or m == 0:
        raise ValueError(f"embed_assign needs rows and a map, got {n} and {m}")
    rff = map_kind == "rff"
    if (b is None) == rff:
        raise ValueError("rff takes its phases b, the Mercer kinds none")
    dev = x.device
    build.check_operand(x, "x", dtype=x.dtype, shape=(n, d), device=dev)
    build.check_operand(w, "w", dtype=x.dtype, shape=(m, d), device=dev)
    if rff:
        build.check_operand(b, "b", dtype=torch.float32, shape=(m,),
                            device=dev)
    build.check_operand(v, "v", dtype=torch.float32, shape=(m, cp), device=dev)
    build.check_operand(csq, "csq", dtype=torch.float32, shape=(cp,), device=dev)
    labels = torch.empty((n,), dtype=torch.int32, device=dev)
    score = torch.empty((n,), dtype=torch.float32, device=dev)
    norms = None if rff else torch.empty((n + m,), dtype=torch.float32,
                                         device=dev)
    head = (x.data_ptr(), w.data_ptr(), b.data_ptr() if rff else 0,
            0 if rff else norms.data_ptr(), v.data_ptr(), csq.data_ptr(),
            labels.data_ptr(), score.data_ptr())
    statics = (MAP_KINDS[map_kind], float(gamma), float(coef0), int(degree),
               float(scale))
    if x.dtype == torch.float32:
        build.launch(_ENTRY[x.dtype], *head, n, m, d, cp, *statics,
                     *f32_geometry(m))
    else:
        splits = landmark_splits(n, m, _sm_count(dev.index),
                                 ctas_per_sm(cp, map_kind, dev.index), BF16)
        # one split takes the argmin in the kernel: no partial F
        part = (0 if splits == 1 else torch.empty(
            (splits, n, cp), dtype=torch.float32, device=dev).data_ptr())
        build.launch(_ENTRY[x.dtype], *head, part, n, m, d, cp, splits,
                     *statics)
    return labels, score
