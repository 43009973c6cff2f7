"""Plain PyTorch versions of the two kernels (the correctness contract).

``kernel_matrix_ref`` and ``assign_fused_ref`` compute what the CUDA kernels
compute, the straightforward way: round the tile operands to the tile dtype
(bf16 round-to-nearest-even), lift them to f32, and do all math in f32,
materializing the Gram block. The argmin takes the lowest index on ties.

The ``ops`` wrappers run these for tensors on the CPU. On the card they run
only where ``chip_smoke.py`` holds a kernel against its plain version;
``CALLS`` counts their calls so a run on the card can show they stayed
unused on the main path.
"""
from __future__ import annotations

import torch

#: calls of each plain version (plain integers; reset by the caller)
CALLS = {"kernel_matrix_ref": 0, "assign_fused_ref": 0}


def _tile(a: torch.Tensor, precision: str) -> torch.Tensor:
    """Round to the tile dtype, then lift to f32 (the accumulate dtype)."""
    if precision == "bf16":
        a = a.to(torch.bfloat16)
    return a.to(torch.float32)


def kernel_matrix_ref(x: torch.Tensor, y: torch.Tensor, *, kind: str = "rbf",
                      gamma: float = 1.0, coef0: float = 1.0, degree: int = 3,
                      precision: str = "f32") -> torch.Tensor:
    """K(X, Y) -> [m, n] f32, f32 math over tile-dtype operands."""
    CALLS["kernel_matrix_ref"] += 1
    xf = _tile(x, precision)
    yf = _tile(y, precision)
    dot = xf @ yf.T
    if kind == "linear":
        return dot
    if kind == "polynomial":
        return (gamma * dot + coef0) ** degree
    if kind == "cosine":
        xn = torch.sqrt(torch.sum(xf * xf, dim=1))[:, None]
        yn = torch.sqrt(torch.sum(yf * yf, dim=1))[None, :]
        return dot / torch.clamp(xn * yn, min=1e-12)
    if kind == "rbf":
        d2 = (torch.sum(xf * xf, dim=1)[:, None]
              + torch.sum(yf * yf, dim=1)[None, :] - 2.0 * dot)
        return torch.exp(-gamma * torch.clamp(d2, min=0.0))
    raise ValueError(f"unknown kernel kind {kind!r}")


def assign_fused_ref(x: torch.Tensor, landmarks: torch.Tensor,
                     h_norm: torch.Tensor, g: torch.Tensor, *,
                     kind: str = "rbf", gamma: float = 1.0,
                     coef0: float = 1.0, degree: int = 3,
                     precision: str = "f32"):
    """x: [n, d]; landmarks: [L, d]; h_norm: [L, C] one-hot/counts;
    g: [C] compactness (+1e30 on empty clusters).
    Returns (labels [n] int32, mind [n] f32, f [n, C] f32) with
      f = K(x, landmarks) @ h_norm            (Eq.17)
      labels = argmin_j g_j - 2 f_ij          (Eq.15, lowest index on ties)
    """
    CALLS["assign_fused_ref"] += 1
    k = kernel_matrix_ref(x, landmarks, kind=kind, gamma=gamma, coef0=coef0,
                          degree=degree, precision=precision)
    f = k @ h_norm.to(torch.float32)
    dist = g[None, :].to(torch.float32) - 2.0 * f
    # torch.argmin returns the first (lowest) index among tied minima
    return (torch.argmin(dist, dim=1).to(torch.int32),
            torch.amin(dist, dim=1), f)
