"""Random Fourier feature maps for the rbf kernel (Rahimi & Recht), the port
of ``repro/approx/rff.py``.

With ``w_r ~ N(0, 2 gamma I_d)`` and ``b_r ~ U[0, 2 pi)`` the map

    z(x) = sqrt(2/m) * cos(W x + b)             z: R^d -> R^m

satisfies ``E[z(x) . z(y)] = exp(-gamma |x - y|^2)`` with variance O(1/m),
so kernel k-means on X becomes linear k-means on Z = z(X). The orthogonal
variant (ORF) stacks QR blocks of a Gaussian with chi-distributed row norms,
which lowers the variance at the same m.

``rff_features`` is a plain ``torch.matmul`` and ``cos``: the reference
computes it outside any Pallas kernel too. Only the fused prediction
(``kernels/ops.embed_assign``) runs a CUDA kernel.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class RFFMap:
    """Frozen sampled feature map: z(x) = scale * cos(x @ w.T + b)."""

    w: torch.Tensor   # [m, d] spectral frequencies
    b: torch.Tensor   # [m]    phases in [0, 2 pi)
    scale: float      # sqrt(2/m)

    kind = "rff"

    @property
    def dim(self) -> int:
        return self.w.shape[0]

    @property
    def in_dim(self) -> int:
        return self.w.shape[1]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return rff_features(x, self)


def _orthogonal_frequencies(gen: torch.Generator, m: int, d: int):
    """[m, d] block-orthogonal rows with chi(d) norms (ORF): ceil(m/d)
    independent d x d QR blocks, so each row is marginally N(0, I_d)."""
    n_blocks = -(-m // d)
    g = torch.randn((n_blocks, d, d), generator=gen)
    q = torch.linalg.qr(g)[0]                                 # [nb, d, d]
    norms = torch.sqrt(torch.sum(
        torch.randn((n_blocks, d, d), generator=gen) ** 2, dim=-1))
    return (q * norms[..., None]).reshape(n_blocks * d, d)[:m]


def make_rff(gen: torch.Generator, d: int, m: int, spec, *,
             orthogonal: bool = False, device=None) -> RFFMap:
    """Sample an m-dimensional random Fourier map for ``spec`` (rbf only)
    over R^d from the CPU generator ``gen``; the tables go to ``device``
    (``None``: the card, raising without one)."""
    device = resolve_device(device)
    if spec.name != "rbf":
        raise ValueError(
            f"RFF requires a shift-invariant kernel; got {spec.name!r} "
            "(use method='nystrom' for non-rbf kernels)")
    if m < 1:
        raise ValueError(f"embedding dim m must be >= 1, got {m}")
    if orthogonal:
        w = _orthogonal_frequencies(gen, m, d)
    else:
        w = torch.randn((m, d), generator=gen)
    # exp(-gamma |x-y|^2) has spectral density N(0, 2 gamma I)
    w = w * math.sqrt(2.0 * spec.gamma)
    b = torch.rand((m,), generator=gen) * (2.0 * math.pi)
    return RFFMap(w=w.to(device), b=b.to(device), scale=math.sqrt(2.0 / m))


def rff_features(x: torch.Tensor, fmap: RFFMap) -> torch.Tensor:
    """z(X) -> [n, m] f32 (f32 projection whatever the input dtype)."""
    proj = x.to(torch.float32) @ fmap.w.to(torch.float32).T
    return fmap.scale * torch.cos(proj + fmap.b[None, :])
