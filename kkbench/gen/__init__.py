"""Input generators: one module per ``generator`` name a configuration
gives, each with ``make(params, seed, device, test_seed) -> Data``. They
are PyTorch copies of ``repro_torch.data.synthetic``'s numpy generators,
drawn on the device in a few large calls: the training set from ``seed``
(a cell's ``data_seed``), the held-out rows of the same classes from
``test_seed`` (the run's ``--seed``), so the same seeds give the same
rows."""
from __future__ import annotations

import dataclasses
import importlib

import torch

#: rows drawn per call where a draw would otherwise hold several copies of
#: the whole dataset at once (fixed, so the draws do not depend on memory)
CHUNK = 262144


@dataclasses.dataclass
class Data:
    x: torch.Tensor          # [n, d] f32 training rows, on the device
    y: torch.Tensor          # [n] int64 generator labels
    x_test: torch.Tensor     # [n_test, d] f32 held-out rows
    y_test: torch.Tensor     # [n_test] int64


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def make(params: dict, seed: int, device, test_seed: int) -> Data:
    """The data of a configuration's ``data`` block."""
    mod = importlib.import_module(f"kkbench.gen.{params['generator']}")
    return mod.make(params, seed, torch.device(device), test_seed)
