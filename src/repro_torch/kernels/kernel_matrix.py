"""Launcher of the CUDA kernel ``kernel_matrix`` (``csrc/kernel_matrix.cu``).

The port of ``kernel_matrix_pallas`` (``repro/kernels/kernel_matrix.py:78``):
K(X, Y) [M, N] f32 with f32 accumulation and the Mercer epilogue for rbf,
polynomial, cosine or linear. Two bodies: a tile body for wide Y (the Gram
builds: 3xTF32 at f32, wgmma at bf16, on a persistent grid of
``tile_ctas``) and a column body for skinny Y (the k-means++ columns and
the Eq.8 / predict blocks), which reads X once; ``route`` picks one. Both
compute |x|^2 and |y|^2 in the launch. The source's header says what
bounds each on an H100 and how it is laid out. ``ops.kernel_matrix`` is
the wrapper callers use; this module only checks operands, routes, sizes
the grid and launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

#: epilogue codes of ``epilogue.cuh``'s ``Kind``
KINDS = {"linear": 0, "polynomial": 1, "cosine": 2, "rbf": 3}
#: features per 16-byte vector load: D must be a multiple of it
VEC = {torch.float32: 4, torch.bfloat16: 8}
_ENTRY = {("tile", torch.float32): "rt_kernel_matrix_f32",
          ("tile", torch.bfloat16): "rt_kernel_matrix_bf16",
          ("column", torch.float32): "rt_kernel_matrix_col_f32",
          ("column", torch.bfloat16): "rt_kernel_matrix_col_bf16"}
_OCCUPANCY = {torch.float32: "rt_kernel_matrix_f32_ctas_per_sm",
              torch.bfloat16: "rt_kernel_matrix_bf16_ctas_per_sm"}
#: the tile bodies' tiles (rows, columns): gram_f32.cuh 128 x 64 (four
#: warps), gram_bf16.cuh 128 x 128 (two warpgroups of wgmma m64n128)
TILE = {torch.float32: (128, 64), torch.bfloat16: (128, 128)}

#: Y's widths the column body is instantiated for (``col::dispatch``): N
#: runs in the fewest columns >= N, the rest zero
COL_WIDTHS = (1, 4, 8, 16, 32)
#: the widest Y the route sends to the column body: all its widths. In the
#: sweep of ``launch/kernel_ab.py`` at [15000, N] x 784 (N = 1, 4, 5, 10,
#: 16, 32; NVIDIA H100 80GB HBM3, 700 W) the column body took 0.019-0.073
#: ms of the card's time at f32 and 0.012-0.068 at bf16, the tile body with
#: the norm pass it needs 0.143-0.146 and 0.132-0.137 at every N: one pass
#: over X against a 128-column tile and a second read of X. Past 32 the
#: column body's time grows with N and the tile body's does not.
NCOL_MAX = 32
#: Y [width, D] and |y|^2 f32 in shared memory: at most what a block may
#: use
COL_SMEM_MAX = 232448


def col_smem_bytes(n: int, d: int) -> int:
    """Shared memory of the column body for Y [n, d]."""
    return 4 * (d + 1) * next(w for w in COL_WIDTHS if w >= n)


@functools.lru_cache(maxsize=256)
def route(n: int, d: int) -> str:
    """"column" for Y [n, d] with 0 < n <= ``NCOL_MAX`` whose staged copy
    fits in shared memory, else "tile"."""
    if 0 < n <= NCOL_MAX and col_smem_bytes(n, d) <= COL_SMEM_MAX:
        return "column"
    return "tile"


def tile_ctas(m: int, n: int, dtype: torch.dtype, sms: int,
              ctas_per_sm: int) -> int:
    """The tile body's persistent grid for K [m, n]: a CTA per slot of the
    card (``sms`` x ``ctas_per_sm``), no more than the tiles; CTA i walks
    tiles [i T / G, (i + 1) T / G) of the T in row-major order."""
    bm, bn = TILE[dtype]
    tiles = -(-m // bm) * -(-n // bn)
    return max(1, min(tiles, sms * ctas_per_sm))


@functools.lru_cache(maxsize=None)
def ctas_per_sm(dtype: torch.dtype, kind: str, index: int) -> int:
    """CTAs of the ``dtype`` tile body (``kind``'s instantiation) one SM of
    card ``index`` holds, from the CUDA occupancy calculator."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = getattr(build.load(), _OCCUPANCY[dtype])(
            KINDS[kind], ctypes.addressof(out))
    if err or out.value < 1:
        raise RuntimeError(f"{_OCCUPANCY[dtype]} gave {out.value} CTAs, "
                           f"CUDA error {err}")
    return out.value


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_matrix_cuda(x: torch.Tensor, y: torch.Tensor, *, kind: str,
                       gamma: float, coef0: float, degree: int,
                       body: str | None = None) -> torch.Tensor:
    """x [M, D], y [N, D] in f32 or bf16 (D a multiple of ``VEC``) ->
    [M, N] f32. ``body`` forces "tile" or "column" (default: ``route``).
    Either body computes |x|^2 and |y|^2 of the same values in the
    launch."""
    if kind not in KINDS:
        raise ValueError(f"kernel_matrix has no epilogue for {kind!r}")
    if x.dtype not in VEC:
        raise TypeError(f"kernel_matrix takes f32 or bf16 tiles, got {x.dtype}")
    m, d = x.shape
    n = y.shape[0]
    if d % VEC[x.dtype]:
        raise ValueError(f"D={d} must be a multiple of {VEC[x.dtype]}")
    if body is None:
        body = route(n, d)
    elif body == "column" and not (0 < n <= COL_WIDTHS[-1]
                                   and col_smem_bytes(n, d) <= COL_SMEM_MAX):
        raise ValueError(f"the column body takes 1 to {COL_WIDTHS[-1]} "
                         f"columns within {COL_SMEM_MAX} bytes, got N={n}, "
                         f"D={d}")
    dev = x.device
    build.check_operand(x, "x", dtype=x.dtype, shape=(m, d), device=dev)
    build.check_operand(y, "y", dtype=x.dtype, shape=(n, d), device=dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    epi = (KINDS[kind], float(gamma), float(coef0), int(degree))
    if body == "column":
        build.launch(_ENTRY[body, x.dtype], x.data_ptr(), y.data_ptr(),
                     out.data_ptr(), m, n, d, *epi)
        return out
    norms = torch.empty((m + n,), dtype=torch.float32, device=dev)
    ctas = tile_ctas(m, n, x.dtype, _sm_count(dev.index),
                     ctas_per_sm(x.dtype, kind, dev.index))
    build.launch(_ENTRY[body, x.dtype], x.data_ptr(), y.data_ptr(),
                 norms.data_ptr(), out.data_ptr(), m, n, d, ctas, *epi)
    return out
