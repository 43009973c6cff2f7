"""Nystrom landmark embedding (Williams & Seeger; Chitta et al. for
k-means), the port of ``repro/approx/nystrom.py``.

Pick m landmarks L from a data sample and whiten the landmark Gram matrix,

    K_LL = U diag(lam) U^T        (eigendecomposition, clamped at eps)
    z(x) = K(x, L) U diag(lam)^{-1/2}          z: R^d -> R^m

so that ``z(x) . z(y) = K(x, L) K_LL^+ K(L, y)``, the rank-m Nystrom
approximation of the Gram matrix, for any Mercer kernel. The Gram blocks
go through ``KernelSpec``, which is the ``kernel_matrix`` CUDA kernel on the
card. Which landmarks is a strategy (``approx.selectors``: uniform, rls,
kpp).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class NystromMap:
    """Frozen landmark embedding: z(x) = K(x, L) @ proj."""

    landmarks: torch.Tensor   # [m, d] landmark features
    proj: torch.Tensor        # [m, m] U diag(lam)^{-1/2} whitening
    spec: object              # the KernelSpec the map approximates

    kind = "nystrom"

    @property
    def dim(self) -> int:
        return self.proj.shape[1]

    @property
    def in_dim(self) -> int:
        return self.landmarks.shape[1]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return nystrom_features(x, self)


def _gram(x: torch.Tensor, y: torch.Tensor, spec) -> torch.Tensor:
    return spec(x, y).to(torch.float32)


def whiten_gram(k: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """K^{-1/2} of a PSD Gram block by a clamped ``eigh``: eigenvalues below
    ``eps * lam_max`` are zeroed, since inverting them amplifies noise.
    Eigenvector signs and order differ between libraries; U diag(lam)^-1/2
    U^T and z z^T do not."""
    k = 0.5 * (k + k.T)
    lam, u = torch.linalg.eigh(k)
    good = lam > eps * torch.clamp(torch.max(lam), min=eps)
    inv_sqrt = torch.where(good, 1.0 / torch.sqrt(torch.clamp(lam, min=eps)),
                           torch.zeros_like(lam))
    return u * inv_sqrt[None, :]


def nystrom_from_landmarks(landmarks: torch.Tensor, spec, *,
                           eps: float = 1e-6) -> NystromMap:
    """Whiten an already-selected landmark set into a ``NystromMap`` (the
    embedding dim stays m even where the effective rank is lower)."""
    k_ll = _gram(landmarks, landmarks, spec)                     # [m, m]
    return NystromMap(landmarks=landmarks, proj=whiten_gram(k_ll, eps=eps),
                      spec=spec)


def make_nystrom(gen: torch.Generator, x: torch.Tensor, m: int, spec, *,
                 eps: float = 1e-6, selector=None) -> NystromMap:
    """An m-landmark Nystrom map from the sample ``x`` [n, d]. ``selector``
    (a name or ``approx.selectors.LandmarkSelector``) picks the landmark
    rows with the CPU generator ``gen``; ``None`` or "uniform" draws them
    uniformly without replacement, as this function always did."""
    from .selectors import resolve
    n = x.shape[0]
    if not 1 <= m <= n:
        raise ValueError(f"need 1 <= m <= n={n} landmarks, got m={m}")
    idx = resolve(selector).select_indices(gen, x, m, spec)
    return nystrom_from_landmarks(x[idx], spec, eps=eps)


def nystrom_features(x: torch.Tensor, fmap: NystromMap) -> torch.Tensor:
    """z(X) -> [n, m] f32."""
    return _gram(x, fmap.landmarks, fmap.spec) @ fmap.proj.to(torch.float32)
