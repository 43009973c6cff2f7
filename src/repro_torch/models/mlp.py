"""Dense SwiGLU FFN (the port of ``repro/models/mlp.py``'s ``init_mlp`` and
``mlp_block``). The mixture of experts waits for the ``moe`` family."""
from __future__ import annotations

import torch

from .common import ParamBuilder, swiglu


def init_mlp(b: ParamBuilder, d_model: int, d_ff: int, prefix: str = ""):
    b.dense(prefix + "w_gate", (d_model, d_ff))
    b.dense(prefix + "w_up", (d_model, d_ff))
    b.dense(prefix + "w_down", (d_ff, d_model))


def mlp_block(p, x: torch.Tensor, prefix: str = "") -> torch.Tensor:
    h = swiglu(x @ p[prefix + "w_gate"], x @ p[prefix + "w_up"])
    return h @ p[prefix + "w_down"]
