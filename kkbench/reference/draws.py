"""The fit's random draws, as the program documents them: batch i draws
from a CPU ``torch.Generator`` seeded from ``SeedSequence([seed, i])``
(two 32-bit words, high word first), the feature map from
``SeedSequence([seed], spawn_key=(1,))``. Within a batch the generator
first draws the landmarks (paper §3.2: a uniform sample without
replacement, sorted; no draw where every row is one), then, in batch 0,
k-means++'s seeds among them. The reference draws the same numbers from
the same seeds; it receives none of them from the program."""
from __future__ import annotations

import numpy as np
import torch


def seeded(entropy, spawn_key=()) -> torch.Generator:
    hi, lo = np.random.SeedSequence(entropy,
                                    spawn_key=spawn_key).generate_state(2)
    return torch.Generator().manual_seed(int(hi) << 32 | int(lo))


def batch_generator(seed: int, i: int) -> torch.Generator:
    return seeded([seed, i])


def map_generator(seed: int) -> torch.Generator:
    return seeded([seed], spawn_key=(1,))


def n_landmarks(n: int, s: float, c: int, multiple_of: int = 1) -> int:
    """|L| of an n-row batch (Eq.18): ceil(s n), at least C, rounded up to
    ``multiple_of`` (a mesh's row count: every rank holds as many
    landmarks) and down to it where that passes n."""
    m = max(int(-(-s * n // 1)), c)
    if multiple_of > 1:
        m = -(-m // multiple_of) * multiple_of
        if m > n:
            m = (n // multiple_of) * multiple_of
    return m


def landmarks(gen: torch.Generator, n: int, m: int):
    """The sorted indices of ``m`` landmarks among ``n`` rows drawn from
    ``gen``; None (no draw) where every row is one."""
    if m == n:
        return None
    return torch.sort(torch.randperm(n, generator=gen)[:m]).values
