"""The program's entry points, one module per ``entry`` name a cell gives.
Each holds a ``Runner(cell, data, device)`` with ``warm()``, ``step(seed)
-> StepOut`` and ``close()``; a step is one planned fit of the whole
training set with that fit seed, then ``predict`` on the held-out rows.
This is the only code of the harness that calls the program."""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass
class StepOut:
    seed: int                 # the fit's seed
    history: list             # the program's BatchStats, one a batch
    states: list              # the program's state after each batch
    labels: object            # predict's labels of the held-out rows
    rows: list                # rows of each batch
    fmap: object = None       # the feature map of an embedded fit


@dataclasses.dataclass(frozen=True)
class Shape:
    """What the harness needs to know of a cell's fit to count its work."""
    engine: str               # GramEngine mode, or the embedding method
    world: int
    predicted_bytes: float    # the program's own price of one batch

    def panel(self, rows: int, s: float) -> tuple:
        """The Gram panel one rank's share of a batch of ``rows`` rows
        needs, (rows, cols): its rows against every landmark. The
        landmarks' own rows of it (K_ll, all of it at s = 1) are counted
        in it, however often the program builds or reads them apart."""
        n_l = max(int(-(-s * rows // 1)), 1)
        return -(-rows // self.world), n_l


def load(name: str):
    return importlib.import_module(f"kkbench.entries.{name}")


def build_kernels() -> None:
    """Compile the program's CUDA kernels into the checkout's ``build/``
    ahead of their first launch (a world's rank 0, before the other ranks
    launch theirs)."""
    from repro_torch.kernels import build
    build.build()
