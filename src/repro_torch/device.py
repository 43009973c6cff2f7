"""Device resolution for the port's entry points.

Every entry point takes ``device=``. ``None`` means the GPU; when no CUDA
device is visible the call raises and names the way out (``device="cpu"``)
instead of quietly running somewhere slower.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raising when there is none); else ``device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: repro_torch runs on the GPU by "
                "default; pass device='cpu' to run its plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)
