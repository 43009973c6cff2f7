"""``kkbench/work.py``'s counts against hand counts."""
from __future__ import annotations

import pytest

from kkbench import work


def test_peaks_are_the_data_sheet_dense_rates():
    assert work.peak_flops("f32") == 495e12
    assert work.peak_flops("bf16") == 989e12
    assert work.peak_bytes() == 3.35e12


def test_kernel_matrix_tile_counts():
    # K(X [3, 2], Y [4, 2]): 3 * 4 dot products of 2 multiply-adds; X, Y
    # read once (f32), K written once
    assert work.kernel_matrix_tile(3, 4, 2) == (48.0, 4 * (6 + 8) + 4 * 12)
    assert work.kernel_matrix_tile(3, 4, 2, itemsize=2)[1] == 2 * 14 + 48


def test_gram_matvec_counts():
    # [5, 7] panel times [7, 3]: 5 * 3 sums of 7 products
    assert work.gram_matvec(5, 7, 3) == (210.0, 4.0 * (35 + 21 + 15))


def test_embed_assign_counts():
    # 10 rows, d 4 -> m 3, C 2, over 2 launches: the map and centroid
    # panel read by each launch, labels and scores written
    f, b = work.embed_assign(10, 4, 3, 2, 2)
    assert f == 2 * 10 * 4 * 3 + 2 * 10 * 3 * 2
    assert b == 4 * 10 * 4 + 2 * 4 * (12 + 3 + 6 + 2) + 8 * 10


def test_fit_flops():
    # one exact batch: K(X_b, L) once, then 3 sweeps of [6, 6] x [6, 2]
    assert work.exact_batch_flops(6, 6, 5, 2, 3) == 2 * 36 * 5 + 3 * 2 * 36 * 2
    assert work.rff_batch_flops(6, 5, 4, 2, 3) == 2 * 6 * 5 * 4 + 3 * 2 * 6 * 4 * 2


def test_bound_takes_the_larger_side():
    assert work.bound_seconds(495e12, 0.0, "f32") == pytest.approx(1.0)
    assert work.bound_seconds(1.0, 3.35e12, "f32") == pytest.approx(1.0)
    assert work.bound_seconds(989e12, 3.35e11, "bf16") == pytest.approx(1.0)
