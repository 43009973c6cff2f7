"""Landmark selection (paper §3.2), the port of ``repro/core/landmarks.py``.

The centroid expansion (Eq.14) is restricted to |L| landmarks per
mini-batch, ``s = (|L| / N) * B`` (Eq.18), so ``s = 1`` is the exact
mini-batch algorithm. The port has the paper's uniform selector so far;
the leverage-aware ones (``rls``, ``kpp``) arrive with a later slice.
Draws come from a CPU ``torch.Generator``, so CPU and GPU runs of the same
seed pick the same landmarks.
"""
from __future__ import annotations

import torch

SELECTORS = ("uniform", "rls", "kpp")


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
    """Validate a selector name; the non-uniform ones are a later slice."""
    if selector not in SELECTORS:
        raise ValueError(
            f"unknown landmark selector {selector!r}; have {SELECTORS}")
    if selector != "uniform":
        raise NotImplementedError(
            f"landmark selector {selector!r} is not ported yet: the "
            f"leverage-aware selectors arrive with a later slice (ROADMAP "
            f"Queue 1 item 5); use selector='uniform'")
    return selector


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


def select_landmark_indices(gen: torch.Generator, batch_size: int,
                            n_landmarks: int,
                            selector: str = "uniform") -> torch.Tensor:
    """Strategy-dispatched landmark indices for one mini-batch."""
    check_selector(selector)
    return choose_landmarks(gen, batch_size, n_landmarks)
