"""Kernelized k-means++ seeding and the Eq.8 nearest-medoid init, the port
of ``repro/core/init.py``.

Seeds are picked with probability proportional to the squared feature-space
distance to the nearest chosen seed, d^2(x_i, x_c) = K_ii + K_cc - 2 K_ic.
Greedy variant: each step draws ``2 + floor(ln C)`` candidates from that
distribution and keeps the one that minimizes the potential sum_i min d^2.
Only O(C log C) kernel columns are evaluated, never the full batch block.

The draws come from a CPU ``torch.Generator`` (uniform numbers mapped
through the D^2 cumulative distribution on the device), so no per-step
transfer of the distribution is needed and CPU and GPU runs of the same
seed draw alike up to rounding of the distances.
"""
from __future__ import annotations

import math

import torch

from repro_torch.obs.trace import span

from .kernels import KernelSpec


class GeneratorDraws:
    """k-means++'s draws from a CPU ``torch.Generator``: the first seed
    uniformly, then each step's candidates by the inverse D^2 CDF (uniform
    numbers mapped on the device; an all-zero distance vector, all rows
    duplicates of the seeds, draws uniformly)."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def first(self, n: int) -> int:
        return int(torch.randint(n, (1,), generator=self.gen))

    def candidates(self, mind2: torch.Tensor, n_cand: int) -> torch.Tensor:
        w = torch.where((mind2 > 0).any(), mind2, torch.ones_like(mind2))
        cdf = torch.cumsum(w.to(torch.float64), dim=0)
        u = torch.rand(n_cand, generator=self.gen,
                       dtype=torch.float64).to(mind2.device)
        cands = torch.searchsorted(cdf, u * cdf[-1], right=True)
        return torch.clamp(cands, max=mind2.shape[0] - 1)


def kmeans_pp_indices(x: torch.Tensor, diag_k: torch.Tensor, gen, *,
                      n_clusters: int, spec: KernelSpec) -> torch.Tensor:
    """Pick C seed indices from the batch ``x`` via greedy kernel
    k-means++ -> [C] int64 on ``x``'s device. ``gen`` is a CPU generator,
    or an object with ``GeneratorDraws``' two methods (a test hands in
    another library's draws that way). Runs in an ``obs:kmeanspp`` span."""
    with span("obs:kmeanspp"):
        n, dev = x.shape[0], x.device
        draws = (GeneratorDraws(gen) if isinstance(gen, torch.Generator)
                 else gen)
        diag_k = diag_k.to(torch.float32)
        n_cand = 2 + int(math.log(max(n_clusters, 1)))

        chosen = torch.zeros(n_clusters, dtype=torch.int64, device=dev)
        chosen[0] = draws.first(n)
        mind2 = torch.full((n,), float("inf"), device=dev)
        for t in range(n_clusters - 1):
            c = chosen[t:t + 1]
            kc = spec(x, x[c])[:, 0]                                   # [n]
            d2 = torch.clamp(diag_k + diag_k[c] - 2.0 * kc, min=0.0)
            mind2 = torch.minimum(mind2, d2)
            cands = draws.candidates(mind2, n_cand)
            # greedy: keep the candidate with the smallest resulting potential
            kc2 = spec(x, x[cands])                            # [n, n_cand]
            d2c = torch.clamp(diag_k[:, None] + diag_k[cands][None, :]
                              - 2.0 * kc2, min=0.0)
            pot = torch.sum(torch.minimum(mind2[:, None], d2c), dim=0)
            best = torch.argmin(pot)
            with span("obs:host_read[kmeanspp]"):
                pick = cands[best]       # a 0-dim index is read to the host
            chosen[t + 1] = pick
        return chosen


def assign_to_medoids(x: torch.Tensor, diag_k: torch.Tensor,
                      medoids: torch.Tensor, medoid_diag: torch.Tensor, *,
                      spec: KernelSpec):
    """Eq.8: nearest-medoid labels for a fresh mini-batch, through the
    auxiliary kernel matrix K~ [n, C], in an ``obs:eq8`` span. Returns
    (labels [n] int32, K~)."""
    with span("obs:eq8"):
        k_tilde = spec(x, medoids).to(torch.float32)
        d2 = (diag_k.to(torch.float32)[:, None] + medoid_diag[None, :]
              - 2.0 * k_tilde)
        return torch.argmin(d2, dim=1).to(torch.int32), k_tilde
