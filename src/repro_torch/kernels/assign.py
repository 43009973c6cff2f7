"""Launcher of the CUDA kernel ``assign_fused`` (``csrc/assign.cu``).

The port of ``assign_fused_pallas`` (``repro/kernels/assign.py:146``): for
each block of rows, a CTA loops over landmark tiles, builds each Gram tile
on chip, contracts it at once against the normalized one-hot H into an f
accumulator that stays on chip, and writes f, min_j (g_j - 2 f_ij) and its
argmin (lowest index on ties). The [rows, landmarks] Gram block never
reaches device memory. The f32 body (``csrc/assign_f32.cuh``) splits the
landmark axis over a second grid dimension (``landmark_splits``) into a
scratch [splits, M, Cp] that a second kernel sums in a fixed order; the
bf16 body gives each 128-row CTA all the landmarks. ``ops.assign_fused``
and ``ops.gram_matvec`` are the wrappers callers use; this module only
checks operands, chooses the split and launches.
"""
from __future__ import annotations

import ctypes
import functools

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

#: the f32 body's grid geometry (csrc/assign_f32.cuh): rows per CTA and
#: landmarks per tile
F32_BM, F32_BN = 128, 64
#: a split runs at least this many landmark tiles, and there are at most
#: MAX_SPLITS of them
MIN_SPLIT_TILES, MAX_SPLITS = 4, 32
#: the fewest splits whose share is within this of the best one's win:
#: more splits would add scratch ([splits, M, Cp]) for no gain
SHARE_SLACK = 0.03


@functools.lru_cache(maxsize=None)
def f32_ctas_per_sm(cp: int, kind: str, index: int) -> int:
    """CTAs of the f32 body (``kind``'s instantiation) one SM of card
    ``index`` holds at Cp clusters, from the CUDA occupancy calculator."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = build.load().rt_assign_f32_ctas_per_sm(cp, KINDS[kind],
                                                     ctypes.addressof(out))
    if err or out.value < 1:
        raise RuntimeError(f"rt_assign_f32_ctas_per_sm gave "
                           f"{out.value} CTAs, CUDA error {err}")
    return out.value


def landmark_splits(m: int, n_landmarks: int, sms: int,
                    ctas_per_sm: int) -> int:
    """How many ranges of landmark tiles the f32 body splits L into, for m
    rows on ``sms`` SMs holding ``ctas_per_sm`` CTAs each.

    The grid is (splits, row blocks). Its time goes as the waves of CTAs
    times the longest split, so each candidate is scored by the share of
    that time the work fills: rows x tiles / (waves x slots x longest). The
    fewest splits within ``SHARE_SLACK`` of the best share win; a split
    keeps at least ``MIN_SPLIT_TILES`` tiles, and L within one tile takes
    one split."""
    rows = -(-m // F32_BM)
    tiles = -(-n_landmarks // F32_BN)
    slots = sms * ctas_per_sm
    shares = []
    for s in range(1, min(MAX_SPLITS, max(1, tiles // MIN_SPLIT_TILES)) + 1):
        waves = -(-rows * s // slots)
        shares.append(rows * tiles / (waves * slots * -(-tiles // s)))
    best = max(shares)
    return next(s for s, share in enumerate(shares, 1)
                if share >= best - SHARE_SLACK)


def split_ranges(n_landmarks: int, splits: int) -> list[tuple[int, int]]:
    """The landmark range [lo, hi) of each split, as the kernel cuts them
    (``split_begin`` in ``csrc/assign_f32.cuh``): split s takes tiles
    [s T / S, (s + 1) T / S) of the T = ceil(L / 64) tiles."""
    tiles = -(-n_landmarks // F32_BN)
    edges = [s * tiles // splits for s in range(splits + 1)]
    return [(edges[s] * F32_BN, min(edges[s + 1] * F32_BN, n_landmarks))
            for s in range(splits)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    ptrs = (x.data_ptr(), landmarks.data_ptr(), xsq.data_ptr(),
            lsq.data_ptr(), h.data_ptr(), g.data_ptr(), labels.data_ptr(),
            mind.data_ptr(), f.data_ptr())
    epi = (KINDS[kind], float(gamma), float(coef0), int(degree))
    if x.dtype == torch.bfloat16:
        build.launch(_ENTRY[x.dtype], *ptrs, m, lm, d, cp, *epi)
        return labels, mind, f
    if m == 0 or lm == 0:
        raise ValueError(f"assign_fused needs rows and landmarks, got "
                         f"{m} and {lm}")
    splits = landmark_splits(m, lm, _sm_count(dev.index),
                             f32_ctas_per_sm(cp, kind, dev.index))
    part = f if splits == 1 else torch.empty((splits, m, cp),
                                             dtype=torch.float32, device=dev)
    build.launch(_ENTRY[x.dtype], *ptrs, part.data_ptr(), m, lm, d, cp,
                 splits, *epi)
    return labels, mind, f
