"""Mini-batch sampling strategies (paper §3.1, Fig.1b), a copy of
``repro/data/sampling.py``'s ``batch_indices`` and ``split_batches``.

* stride sampling — X^i = { x_{i + j*B} }: least within-batch correlation.
* block sampling  — X^i = { x_{i*N/B + j} }: streaming-friendly.
"""
from __future__ import annotations

import numpy as np


def batch_indices(n: int, n_batches: int,
                  strategy: str = "stride") -> list[np.ndarray]:
    """Disjoint index sets for B mini-batches. Trailing remainder samples are
    folded into the last batch (the paper assumes N % B == 0)."""
    if n_batches < 1 or n_batches > n:
        raise ValueError(f"need 1 <= B <= N, got B={n_batches}, N={n}")
    if strategy == "stride":
        return [np.arange(i, n, n_batches) for i in range(n_batches)]
    if strategy == "block":
        size = n // n_batches
        out = [np.arange(i * size, (i + 1) * size) for i in range(n_batches)]
        if n % n_batches:
            out[-1] = np.arange((n_batches - 1) * size, n)
        return out
    raise ValueError(f"unknown sampling strategy {strategy!r}")


def split_batches(x: np.ndarray, n_batches: int,
                  strategy: str = "stride") -> list[np.ndarray]:
    return [x[idx] for idx in batch_indices(len(x), n_batches, strategy)]
