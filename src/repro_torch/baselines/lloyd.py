"""Standard (linear) k-means, the paper's scikit-learn baseline (§4.4), the
port of ``repro/baselines/lloyd.py``.

Lloyd iterations with k-means++ seeding, ``n_init`` restarts keeping the
lowest-cost solution (the first on equal cost). Restart i draws from a CPU
``torch.Generator`` seeded ``seed + i``, so the card and the host see the
same draws. The products are plain ``torch.matmul``: the reference runs
them outside any Pallas kernel.

The reference's ``lax.while_loop`` never syncs the host. Here the loop is
Python and its condition reads one ``changed`` flag back per iteration, as
``core/kkmeans.py`` does; ``HOST_READS["lloyd"]`` counts those reads and the
restarts' cost comparisons.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.analysis.dispatch import iteration, loop
from repro_torch.device import resolve_device

HOST_READS = {"lloyd": 0}


class KMeansResult(NamedTuple):
    centers: torch.Tensor   # [C, d]
    labels: torch.Tensor    # [n] int32
    cost: torch.Tensor      # [] inertia, ||x||^2 included
    n_iter: int


def _read(flag: torch.Tensor):
    HOST_READS["lloyd"] += 1
    return flag.item()


def _categorical(logp: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One draw from softmax(logp) by the Gumbel-max rule (lowest index on
    ties), with the uniforms drawn on the CPU."""
    u = torch.rand(logp.shape[0], generator=gen, dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny).to(logp.device)
    return torch.argmax(logp - torch.log(-torch.log(u)))


def _pp_init(x: torch.Tensor, gen: torch.Generator,
             n_clusters: int) -> torch.Tensor:
    """k-means++: a uniform first pick, then categorical over log(min d^2);
    when every distance is 0 the draw is uniform."""
    n = x.shape[0]
    first = int(torch.randint(0, n, (), generator=gen))
    centers = torch.zeros((n_clusters, x.shape[1]), dtype=x.dtype,
                          device=x.device)
    centers[0] = x[first]
    mind2 = torch.full((n,), float("inf"), dtype=torch.float32,
                       device=x.device)
    for t in range(n_clusters - 1):
        d2 = torch.sum((x - centers[t]) ** 2, dim=-1)
        mind2 = torch.minimum(mind2, d2)
        logp = torch.where(mind2 > 0, torch.log(mind2.clamp_min(1e-30)),
                           torch.full_like(mind2, -float("inf")))
        logp = torch.where(torch.isfinite(logp).any(), logp,
                           torch.zeros_like(logp))
        centers[t + 1] = x[_categorical(logp, gen)]
    return centers


def _dists(x: torch.Tensor, xsq: torch.Tensor,
           centers: torch.Tensor) -> torch.Tensor:
    """||x||^2 - 2 x.c + ||c||^2; the first term is constant for the argmin
    but kept so ``cost`` is the true inertia."""
    return (xsq[:, None] - 2.0 * x @ centers.T
            + torch.sum(centers * centers, dim=1)[None])


def _lloyd(x: torch.Tensor, centers: torch.Tensor, *,
           max_iters: int) -> KMeansResult:
    """Lloyd from ``centers`` until max |new - c| <= 1e-7 or ``max_iters``;
    an empty cluster keeps its center."""
    n_clusters = centers.shape[0]
    xsq = torch.sum(x * x, dim=1)
    changed, t = True, 0
    with loop("lloyd"):
        while changed and t < max_iters:
            iteration()
            labels = torch.argmin(_dists(x, xsq, centers), dim=1)
            h = torch.nn.functional.one_hot(labels, n_clusters).to(x.dtype)
            counts = h.sum(dim=0)
            sums = h.T @ x
            new = torch.where(counts[:, None] > 0,
                              sums / counts.clamp_min(1.0)[:, None], centers)
            changed = _read(torch.any(torch.abs(new - centers) > 1e-7))
            centers, t = new, t + 1
    d = _dists(x, xsq, centers)
    mind, labels = torch.min(d, dim=1)
    return KMeansResult(centers, labels.to(torch.int32), torch.sum(mind), t)


def _fit_once(x: torch.Tensor, seed: int, *, n_clusters: int,
              max_iters: int) -> KMeansResult:
    gen = torch.Generator().manual_seed(seed)
    return _lloyd(x, _pp_init(x, gen, n_clusters), max_iters=max_iters)


def kmeans(x, n_clusters: int, *, n_init: int = 5, max_iters: int = 300,
           seed: int = 0, device=None) -> KMeansResult:
    """Best of ``n_init`` k-means++ / Lloyd runs on x [n, d] (f32)."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    best: KMeansResult | None = None
    for i in range(n_init):
        res = _fit_once(x, seed + i, n_clusters=n_clusters,
                        max_iters=max_iters)
        if best is None or _read(res.cost < best.cost):
            best = res
    assert best is not None
    return best
