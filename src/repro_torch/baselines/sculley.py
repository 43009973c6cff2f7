"""Sculley's web-scale SGD mini-batch k-means, the paper's Fig.8 comparison
baseline, the port of ``repro/baselines/sculley.py``.

Per Sculley (WWW 2010): mini-batches of ~10^3 rows, a per-center rate 1/n_c
where n_c counts every assignment ever made to center c, a fixed number of
iterations, each center stepped toward its batch mean. The init rows and
the batch indices come from ``np.random.default_rng(seed)`` exactly as the
reference draws them, so both packages see the same batches; x is uploaded
once and each batch is gathered on the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class SGDKMeansResult(NamedTuple):
    centers: torch.Tensor
    labels: torch.Tensor    # [n] int32 labels of the whole dataset
    cost: torch.Tensor


def _dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    return (torch.sum(x * x, dim=1)[:, None] - 2.0 * x @ centers.T
            + torch.sum(centers * centers, dim=1)[None])


def _sgd_step(centers: torch.Tensor, counts: torch.Tensor, xb: torch.Tensor):
    labels = torch.argmin(_dists(xb, centers), dim=1)
    h = torch.nn.functional.one_hot(labels, centers.shape[0]).to(xb.dtype)
    batch_counts = h.sum(dim=0)
    new_counts = counts + batch_counts
    # eta_c = batch_count_c / new_count_c gives the exact streaming mean:
    # c <- (1 - eta) c + eta * batch_mean_c.
    batch_mean = (h.T @ xb) / batch_counts.clamp_min(1.0)[:, None]
    eta = torch.where(new_counts > 0,
                      batch_counts / new_counts.clamp_min(1.0),
                      torch.zeros_like(new_counts))
    return centers + eta[:, None] * (batch_mean - centers), new_counts


def sgd_minibatch_kmeans(x, n_clusters: int, *, batch_size: int = 1000,
                         n_iters: int = 200, seed: int = 0,
                         device=None) -> SGDKMeansResult:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float32)
    init_idx = rng.choice(len(x), n_clusters, replace=False)
    xd = torch.as_tensor(x, device=dev)
    centers = xd[torch.as_tensor(init_idx, device=dev)]
    counts = torch.zeros((n_clusters,), dtype=torch.float32, device=dev)
    for _ in range(n_iters):
        idx = rng.integers(0, len(x), size=batch_size)
        centers, counts = _sgd_step(centers, counts,
                                    xd[torch.as_tensor(idx, device=dev)])
    d = _dists(xd, centers)
    mind, labels = torch.min(d, dim=1)
    return SGDKMeansResult(centers, labels.to(torch.int32), torch.sum(mind))
