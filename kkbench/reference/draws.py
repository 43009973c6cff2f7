"""The fit's random draws, as the program documents them: batch i draws
from a CPU ``torch.Generator`` seeded from ``SeedSequence([seed, i])``
(two 32-bit words, high word first), the feature map from
``SeedSequence([seed], spawn_key=(1,))``. The reference draws the same
numbers from the same seeds; it receives none of them from the program."""
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
