"""Operations and bytes of each launch and each fit, counted from shapes,
and the table of peaks they are divided by (``peaks.json``).

A launch's work counts each input read once and each output written once,
whatever the kernel reads again, and only the products the algorithm needs
(no padded rows, no epilogue transcendentals)."""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def peak_flops(precision: str) -> float:
    return float(PEAKS["flops_per_s"][precision])


def peak_bytes() -> float:
    return float(PEAKS["bytes_per_s"])


def bound_seconds(flops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peak_flops(precision), nbytes / peak_bytes())


def kernel_matrix_tile(m: int, n: int, d: int, itemsize: int = 4):
    """K(X [m, d], Y [n, d]) -> [m, n] f32: (flops, bytes)."""
    return 2.0 * m * n * d, itemsize * (m + n) * d + 4.0 * m * n


def gram_matvec(rows: int, cols: int, c: int):
    """A materialized [rows, cols] f32 panel times a [cols, C] one-hot:
    (flops, bytes)."""
    return 2.0 * rows * cols * c, 4.0 * (rows * cols + cols * c + rows * c)


def embed_assign(n: int, d: int, m: int, c: int, launches: int):
    """``n`` rows embedded [d -> m] and assigned to C centroids over
    ``launches`` launches, each reading the map and the centroid panel:
    (flops, bytes)."""
    flops = 2.0 * n * d * m + 2.0 * n * m * c
    nbytes = 4.0 * n * d + launches * 4.0 * (m * d + m + m * c + c) + 8.0 * n
    return flops, nbytes


def exact_batch_flops(rows: int, landmarks: int, d: int, c: int,
                      iters: int) -> float:
    """What one exact batch needs: K(X_b, L) once (L within X_b at s = 1,
    counted once), and one [rows, |L|] x [|L|, C] contraction a sweep."""
    return 2.0 * rows * landmarks * d + iters * 2.0 * rows * landmarks * c


def rff_batch_flops(rows: int, d: int, m: int, c: int, iters: int) -> float:
    """What one RFF batch needs: the map once, one [rows, m] x [m, C]
    contraction a sweep."""
    return 2.0 * rows * d * m + iters * 2.0 * rows * m * c
