"""Plain random-Fourier-feature k-means (Rahimi & Recht's map, Lloyd in
the embedded space) in float64, used to judge the program's RFF fits.

The map is drawn again from the fit's seed (``draws.map_generator``):
w ~ N(0, 2 gamma I) as a float32 standard normal times sqrt(2 gamma), b ~
U[0, 2 pi); z(x) = sqrt(2/m) cos(x w^T + b) is evaluated in float64. A
one-batch fit (B = 1) ends with centroids that are the means of its last
labels, and at Lloyd's fixpoint those labels are each row's nearest
centroid; so the program's final centroids are judged by that fixpoint
property on the reference's own embedding, not by a replay of its
iterations. ``tf32=True`` rounds every product's operands to TF32: the
control."""
from __future__ import annotations

import math

import torch

from .draws import batch_generator, map_generator
from .kkmeans import BIG, round_tf32

BLOCK = 65536


def draw_map(seed: int, d: int, m: int, gamma: float):
    gen = map_generator(seed)
    w = torch.randn((m, d), generator=gen) * math.sqrt(2.0 * gamma)
    b = torch.rand((m,), generator=gen) * (2.0 * math.pi)
    return w, b


def _mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        return (round_tf32(a).to(torch.float64)
                @ round_tf32(b).to(torch.float64))
    return a.to(torch.float64) @ b.to(torch.float64)


def embed(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
          tf32: bool = False, block: int = BLOCK) -> torch.Tensor:
    """z(x) [n, m] float64, in row blocks."""
    w, b = w.to(x.device), b.to(x.device).to(torch.float64)
    scale = math.sqrt(2.0 / w.shape[0])
    return torch.cat([scale * torch.cos(_mm(blk, w.T, tf32) + b[None, :])
                      for blk in torch.split(x, block)])


def sqdist(z: torch.Tensor, c: torch.Tensor, *, tf32: bool = False):
    """|z_i - c_j|^2 [n, C] float64."""
    c = c.to(z.device)
    zc = _mm(z, c.T, tf32)
    c = c.to(torch.float64)
    return ((z * z).sum(1)[:, None] + (c * c).sum(1)[None, :]
            - 2.0 * zc).clamp(min=0.0)


def means(z: torch.Tensor, labels: torch.Tensor, c: int):
    h = torch.nn.functional.one_hot(labels.long(), c).to(torch.float64)
    counts = h.sum(0)
    return (h.T @ z) / counts.clamp(min=1.0)[:, None], counts


def judge_final(z: torch.Tensor, centroids, counts, cost: float) -> dict:
    """A one-batch fit's final state against the fixpoint on the
    reference's embedding ``z`` -> compared numbers:

    centroid  the worst cluster's squared distance between the program's
              centroid and the mean of the rows nearest to it, over the
              median row's squared distance to its nearest centroid
    moved     share of rows the cardinalities put elsewhere than the
              nearest-centroid partition does
    cost      |program's cost - sum of nearest squared distances| / the
              latter
    count     |sum of the program's cardinalities - n| / n"""
    c = centroids.to(z.device).to(torch.float64)
    n_c = c.shape[0]
    d2 = sqdist(z, c)
    best, labels = d2.min(dim=1)
    mu, n_ref = means(z, labels, n_c)
    scale = float(torch.median(best))
    shift = torch.where(n_ref > 0, ((mu - c) ** 2).sum(1),
                        torch.zeros_like(n_ref))
    counts = torch.as_tensor(counts, dtype=torch.float64, device=z.device)
    ref_cost = float(best.sum())
    return {"centroid": float(shift.max()) / scale,
            "moved": float((counts - n_ref).abs().sum()) / (2.0 * z.shape[0]),
            "cost": abs(cost - ref_cost) / ref_cost,
            "count": abs(float(counts.sum()) - z.shape[0]) / z.shape[0]}


def predict_gap(z: torch.Tensor, centroids, counts, labels) -> float:
    """The worst held-out row's excess squared distance to the centroid the
    program labelled it with, over its nearest (empty clusters
    unjoinable), divided by the median row's nearest distance."""
    d2 = sqdist(z, centroids)
    counts = torch.as_tensor(counts, device=z.device)
    d2 = torch.where(counts[None, :] > 0, d2, torch.full_like(d2, BIG))
    best = d2.min(dim=1).values
    at = d2.gather(1, torch.as_tensor(labels, device=z.device).long()[:, None])
    return float((at[:, 0] - best).max()) / float(torch.median(best))


def fit(x: torch.Tensor, gamma: float, c: int, m: int, max_iters: int, *,
        seed: int, tf32: bool = False):
    """A one-batch RFF fit: the map, greedy k-means++ seeds on z (linear
    kernel, the draws of batch 0), Lloyd -> (w, b, centroids, counts,
    cost, iters)."""
    w, b = draw_map(seed, x.shape[1], m, gamma)
    z = embed(x, w, b, tf32=tf32)
    if tf32:
        z = round_tf32(z).to(torch.float64)
    gen = batch_generator(seed, 0)
    n = z.shape[0]
    n_cand = 2 + int(math.log(max(c, 1)))
    chosen = [int(torch.randint(n, (1,), generator=gen))]
    mind2 = torch.full((n,), math.inf, dtype=torch.float64, device=z.device)
    for _ in range(c - 1):
        mind2 = torch.minimum(mind2, sqdist(z, z[chosen[-1]][None],
                                            tf32=tf32)[:, 0])
        w8 = mind2 if bool((mind2 > 0).any()) else torch.ones_like(mind2)
        cdf = torch.cumsum(w8, dim=0)
        u = torch.rand(n_cand, generator=gen, dtype=torch.float64)
        cands = torch.searchsorted(cdf, u.to(z.device) * cdf[-1],
                                   right=True).clamp(max=n - 1)
        pot = torch.minimum(mind2[:, None],
                            sqdist(z, z[cands], tf32=tf32)).sum(0)
        chosen.append(int(cands[torch.argmin(pot)]))
    labels = torch.argmin(sqdist(z, z[chosen], tf32=tf32), dim=1)
    t, changed, cost = 0, True, math.inf
    while changed and t < max_iters:
        cents, counts = means(z, labels, c)
        d2 = sqdist(z, cents, tf32=tf32)
        d2 = torch.where(counts[None, :] > 0, d2, torch.full_like(d2, BIG))
        best, new = d2.min(dim=1)
        changed = bool((new != labels).any())
        labels, t, cost = new, t + 1, float(best.sum())
    cents, counts = means(z, labels, c)
    return w, b, cents, counts, cost, t
