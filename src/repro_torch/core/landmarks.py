"""Landmark selection (paper §3.2), the port of ``repro/core/landmarks.py``.

The centroid expansion (Eq.14) is restricted to |L| landmarks per
mini-batch, ``s = (|L| / N) * B`` (Eq.18), so ``s = 1`` is the exact
mini-batch algorithm. *Which* |L| rows is a strategy
(``repro_torch.approx.selectors``: uniform, rls, kpp), and
``select_landmark_indices`` is the dispatch the mini-batch steps call.
Draws come from a CPU ``torch.Generator``, so CPU and GPU runs of the same
seed pick the same uniform landmarks.
"""
from __future__ import annotations

import torch

def num_landmarks(batch_size: int, s: float, *, n_clusters: int,
                  multiple_of: int = 1) -> int:
    """|L| = ceil(s * batch_size), clamped to [C, batch_size]; rounded up
    to ``multiple_of`` for the distributed runtime. Infeasible combinations
    raise instead of shrinking |L| below C."""
    if not (0.0 < s <= 1.0):
        raise ValueError(f"s must be in (0, 1], got {s}")
    if batch_size < n_clusters:
        raise ValueError(
            f"infeasible landmark count: the centroid expansion needs at "
            f"least C={n_clusters} landmarks but the mini-batch has only "
            f"{batch_size} rows — grow the batch (lower B) or lower C")
    l = max(int(-(-s * batch_size // 1)), n_clusters)  # ceil, >= C
    if multiple_of > 1:
        l = -(-l // multiple_of) * multiple_of
        if l > batch_size:
            l = (batch_size // multiple_of) * multiple_of
        if l < n_clusters:
            raise ValueError(
                f"infeasible landmark count: no multiple of {multiple_of} in "
                f"[C={n_clusters}, batch={batch_size}] — shrink the mesh's "
                f"landmark axis, grow the batch (lower B), or lower C")
    return l


def check_selector(selector) -> str:
    """Validate a selector name or instance and return its name."""
    from repro_torch.approx.selectors import name_of
    return name_of(selector)


def choose_landmarks(gen: torch.Generator, batch_size: int,
                     n_landmarks: int) -> torch.Tensor:
    """Uniform sample without replacement of landmark indices, sorted
    (int64, on the CPU)."""
    if n_landmarks > batch_size:
        raise ValueError(f"|L|={n_landmarks} > batch={batch_size}")
    if n_landmarks == batch_size:
        return torch.arange(batch_size)
    idx = torch.randperm(batch_size, generator=gen)[:n_landmarks]
    return torch.sort(idx).values


def select_landmark_indices(gen: torch.Generator, x: torch.Tensor,
                            n_landmarks: int, spec,
                            selector="uniform") -> torch.Tensor:
    """Strategy-dispatched landmark indices for one mini-batch ``x``, on its
    device. ``selector`` is a name or ``approx.selectors.LandmarkSelector``;
    ``spec`` is the ``KernelSpec`` the leverage-aware ones score with.
    ``uniform`` draws ``choose_landmarks(gen, ...)``; the others draw one
    key from ``gen``."""
    from repro_torch.approx.selectors import resolve
    return resolve(selector).select_indices(gen, x, n_landmarks, spec)
