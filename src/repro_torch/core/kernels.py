"""Mercer kernel functions (Gram-block evaluation), the port of
``repro/core/kernels.py``.

``KernelSpec(x, y)`` evaluates a block ``K(X, Y) -> [m, n]`` f32. For rbf,
linear, polynomial and cosine it goes through ``kernels.ops.kernel_matrix``:
the CUDA kernel for tensors on the card, the plain version on the CPU. The
tile dtype follows the operands (bf16 when both are bf16, else f32), so a
block built from rounded features sums the same rounded values the fused
kernel does.

``laplacian`` (L1 distances) stays plain PyTorch on every device: it does
not factor through a product, and the reference has no in-tile epilogue for
it either (``repro/core/engine.py:61-63``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops

KINDS = ("linear", "rbf", "laplacian", "polynomial", "cosine")
#: kinds with an in-tile epilogue in the CUDA kernels
KERNEL_KINDS = ("rbf", "linear", "polynomial", "cosine")


def _laplacian(x: torch.Tensor, y: torch.Tensor, gamma: float) -> torch.Tensor:
    d1 = torch.cdist(x.to(torch.float32), y.to(torch.float32), p=1)
    return torch.exp(-gamma * d1)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Declarative kernel description (hashable)."""

    name: str = "rbf"
    gamma: float = 1.0
    coef0: float = 1.0
    degree: int = 3

    def __post_init__(self):
        if self.name not in KINDS:
            raise ValueError(f"unknown kernel {self.name!r}; have {KINDS}")

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.name == "laplacian":
            return _laplacian(x, y, self.gamma)
        both_bf16 = x.dtype == y.dtype == torch.bfloat16
        return ops.kernel_matrix(
            x, y, kind=self.name, gamma=self.gamma, coef0=self.coef0,
            degree=self.degree, precision="bf16" if both_bf16 else "f32")

    def diag(self, x: torch.Tensor) -> torch.Tensor:
        """K(x_i, x_i) for every row — no Gram block."""
        if self.name in ("rbf", "laplacian", "cosine"):
            return torch.ones((x.shape[0],), dtype=torch.float32,
                              device=x.device)
        sq = torch.sum(x.to(torch.float32) ** 2, dim=-1)
        if self.name == "linear":
            return sq
        return (self.gamma * sq + self.coef0) ** self.degree

    def paired(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """K(a_i, b_i) for each row pair -> [n] f32 (plain PyTorch; the
        reference evaluates one 1x1 Gram block per pair)."""
        a, b = a.to(torch.float32), b.to(torch.float32)
        if self.name == "laplacian":
            return torch.exp(-self.gamma * torch.sum(torch.abs(a - b), dim=-1))
        dot = torch.sum(a * b, dim=-1)
        if self.name == "linear":
            return dot
        if self.name == "polynomial":
            return (self.gamma * dot + self.coef0) ** self.degree
        aa, bb = torch.sum(a * a, dim=-1), torch.sum(b * b, dim=-1)
        if self.name == "cosine":
            return dot / torch.clamp(torch.sqrt(aa) * torch.sqrt(bb), min=1e-12)
        return torch.exp(-self.gamma * torch.clamp(aa + bb - 2.0 * dot, min=0.0))


def gamma_from_dmax(x: torch.Tensor, *, factor: float = 4.0) -> float:
    """The paper's sigma = 4*d_max rule (§4.4): gamma = 1 / (2 sigma^2),
    d_max the bounding-box diagonal, computed in float32 as the reference
    does so that gamma matches."""
    span = torch.amax(x, dim=0) - torch.amin(x, dim=0)
    d_max = float(torch.sqrt(torch.sum(span.to(torch.float32) ** 2)))
    sigma = factor * max(d_max, 1e-12)
    return 1.0 / (2.0 * sigma * sigma)
