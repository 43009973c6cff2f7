"""Launcher of the CUDA kernel ``assign_fused`` (``csrc/assign.cu``).

The port of ``assign_fused_pallas`` (``repro/kernels/assign.py:146``): for
each block of rows, a CTA loops over landmark tiles, builds each Gram tile
on chip, contracts it at once against the normalized one-hot H into an f
accumulator that stays on chip, and writes f, min_j (g_j - 2 f_ij) and its
argmin (lowest index on ties). The [rows, landmarks] Gram block never
reaches device memory. Both bodies (``csrc/assign_f32.cuh``,
``csrc/assign_bf16.cuh``) split the landmark axis over a second grid
dimension (``landmark_splits``, with each body's ``Geometry``) into a
scratch [splits, M, Cp] that a second kernel sums in a fixed order.
``ops.assign_fused`` and ``ops.gram_matvec`` are the wrappers callers use;
this module only checks operands, chooses the split and launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build
from .kernel_matrix import KINDS, VEC, _sm_count

#: cluster columns per contraction chunk: Cp must be a multiple of it
CP_MULTIPLE = 16
#: the f accumulator [128, Cp] f32 must fit in shared memory beside the
#: tile; ``ops`` launches once per chunk of this many clusters
MAX_CP = 256
_ENTRY = {torch.float32: "rt_assign_fused_f32",
          torch.bfloat16: "rt_assign_fused_bf16"}
_OCCUPANCY = {torch.float32: "rt_assign_f32_ctas_per_sm",
              torch.bfloat16: "rt_assign_bf16_ctas_per_sm"}


class Geometry(NamedTuple):
    """A body's split grid: rows per CTA, landmarks per tile, and the
    fewest tiles a split runs when there are several splits."""
    bm: int
    bn: int
    min_split_tiles: int


#: csrc/assign_f32.cuh: 128 rows of four warps, tiles of 64 landmarks
F32 = Geometry(bm=128, bn=64, min_split_tiles=4)
#: csrc/assign_bf16.cuh: 128 rows of two warpgroups, tiles of 128
#: landmarks (the wgmma width); two tiles a split at least, so that the
#: g stats' 3000 x 3000 (24 row blocks x 24 tiles) can take 8 splits
BF16 = Geometry(bm=128, bn=128, min_split_tiles=2)
GEOMETRY = {torch.float32: F32, torch.bfloat16: BF16}
#: at most this many splits
MAX_SPLITS = 32
#: the fewest splits whose share is within this of the best one's win:
#: more splits would add scratch ([splits, M, Cp]) for no gain
SHARE_SLACK = 0.03


@functools.lru_cache(maxsize=None)
def occupancy(entry: str, cp: int, code: int, index: int) -> int:
    """CTAs of a body one SM of card ``index`` holds at Cp clusters, from
    the CUDA occupancy calculator behind the C entry ``entry`` (the body's
    instantiation of epilogue code ``code``)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = getattr(build.load(), entry)(cp, code, ctypes.addressof(out))
    if err or out.value < 1:
        raise RuntimeError(f"{entry} gave {out.value} CTAs, CUDA error {err}")
    return out.value


def ctas_per_sm(dtype: torch.dtype, cp: int, kind: str, index: int) -> int:
    """CTAs of the ``dtype`` body (``kind``'s instantiation) one SM of card
    ``index`` holds at Cp clusters."""
    return occupancy(_OCCUPANCY[dtype], cp, KINDS[kind], index)


@functools.lru_cache(maxsize=256)
def landmark_splits(m: int, n_landmarks: int, sms: int, ctas_per_sm: int,
                    geometry: Geometry = F32) -> int:
    """How many ranges of landmark tiles a body of ``geometry`` splits L
    into, for m rows on ``sms`` SMs holding ``ctas_per_sm`` CTAs each.

    The grid is (splits, row blocks). Its time goes as the waves of CTAs
    times the longest split, so each candidate is scored by the share of
    that time the work fills: rows x tiles / (waves x slots x longest). The
    fewest splits within ``SHARE_SLACK`` of the best share win; a split
    keeps at least ``geometry.min_split_tiles`` tiles, and L within one
    tile takes one split."""
    rows = -(-m // geometry.bm)
    tiles = -(-n_landmarks // geometry.bn)
    slots = sms * ctas_per_sm
    shares = []
    for s in range(1, min(MAX_SPLITS,
                          max(1, tiles // geometry.min_split_tiles)) + 1):
        waves = -(-rows * s // slots)
        shares.append(rows * tiles / (waves * slots * -(-tiles // s)))
    best = max(shares)
    return next(s for s, share in enumerate(shares, 1)
                if share >= best - SHARE_SLACK)


def split_ranges(n_landmarks: int, splits: int,
                 geometry: Geometry = F32) -> list[tuple[int, int]]:
    """The landmark range [lo, hi) of each split, as the kernels cut them
    (``range_begin`` in ``csrc/gram_f32.cuh``): split s takes tiles
    [s T / S, (s + 1) T / S) of the T = ceil(L / bn) tiles."""
    bn = geometry.bn
    tiles = -(-n_landmarks // bn)
    edges = [s * tiles // splits for s in range(splits + 1)]
    return [(edges[s] * bn, min(edges[s + 1] * bn, n_landmarks))
            for s in range(splits)]


def assign_fused_cuda(x: torch.Tensor, landmarks: torch.Tensor,
                      h: torch.Tensor, g: torch.Tensor, *, kind: str,
                      gamma: float, coef0: float, degree: int):
    """x [M, D], landmarks [L, D] in f32 or bf16 (D a multiple of ``VEC``);
    h [L, Cp], g [Cp] f32, Cp a multiple of ``CP_MULTIPLE`` and at most
    ``MAX_CP``. The launch computes the row norms of x and landmarks itself
    (once when landmarks is x). Returns (labels [M] int32, mind [M] f32,
    f [M, Cp] f32)."""
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
    if m == 0 or lm == 0:
        raise ValueError(f"assign_fused needs rows and landmarks, got "
                         f"{m} and {lm}")
    dev = x.device
    build.check_operand(x, "x", dtype=x.dtype, shape=(m, d), device=dev)
    build.check_operand(landmarks, "landmarks", dtype=x.dtype, shape=(lm, d),
                        device=dev)
    build.check_operand(h, "h", dtype=torch.float32, shape=(lm, cp), device=dev)
    build.check_operand(g, "g", dtype=torch.float32, shape=(cp,), device=dev)
    labels = torch.empty((m,), dtype=torch.int32, device=dev)
    mind = torch.empty((m,), dtype=torch.float32, device=dev)
    f = torch.empty((m, cp), dtype=torch.float32, device=dev)
    norms = torch.empty((m + lm,), dtype=torch.float32, device=dev)
    splits = landmark_splits(m, lm, _sm_count(dev.index),
                             ctas_per_sm(x.dtype, cp, kind, dev.index),
                             GEOMETRY[x.dtype])
    part = f if splits == 1 else torch.empty((splits, m, cp),
                                             dtype=torch.float32, device=dev)
    build.launch(_ENTRY[x.dtype], x.data_ptr(), landmarks.data_ptr(),
                 norms.data_ptr(), h.data_ptr(), g.data_ptr(),
                 labels.data_ptr(), mind.data_ptr(), f.data_ptr(),
                 part.data_ptr(), m, lm, d, cp, splits, KINDS[kind],
                 float(gamma), float(coef0), int(degree))
    return labels, mind, f
