"""The paper's noisy MNIST (Tab.3) on the MNIST envelope, a device copy of
``make_mnist_like`` and ``make_noisy_replicas``.

The envelope: 784 features, 10 classes, each class a rank-16 affine
manifold (mean U(0, 0.6) on a quarter of the pixels, basis N(0, 1/d)) plus
N(0, 0.05) pixel noise, clipped to [0, 1]. The classes and ``n_base``
envelope rows come from ``seed``; the rows are replicated ``n_replicas``
times, each replica with uniform noise on a Bernoulli ``frac_features``
share of its features, and shuffled. ``n_test`` clean envelope rows of the
same classes, drawn from ``test_seed``, are held out. (The numpy copy
draws ``int(frac * d)`` columns with replacement; a Bernoulli mask keeps
the draw free of duplicate writes, whose order the device does not fix.)"""
from __future__ import annotations

import math

import torch

from . import CHUNK, Data, generator


def classes(g: torch.Generator, p: dict, device):
    c, d = p["n_classes"], p["d"]
    keep = torch.rand((c, d), generator=g, device=device) < 0.25
    means = torch.rand((c, d), generator=g, device=device) * 0.6 * keep
    bases = torch.randn((c, p["rank"], d), generator=g,
                        device=device) / math.sqrt(d)
    return means, bases


def envelope(g: torch.Generator, means, bases, n: int, device):
    c, rank, d = bases.shape
    y = torch.randint(0, c, (n,), generator=g, device=device)
    z = torch.randn((n, rank), generator=g, device=device)
    x = means[y] + 0.05 * torch.randn((n, d), generator=g, device=device)
    for j in range(c):
        idx = torch.nonzero(y == j).squeeze(1)
        x[idx] += z[idx] @ bases[j]
    return x.clamp_(0.0, 1.0), y


def make(p: dict, seed: int, device, test_seed: int) -> Data:
    g = generator(seed, device)
    means, bases = classes(g, p, device)
    base, y = envelope(g, means, bases, p["n_base"], device)
    reps, n = p["n_replicas"], p["n_base"] * p["n_replicas"]
    out = torch.empty((n, p["d"]), dtype=torch.float32, device=device)
    for s in range(0, n, CHUNK):
        rows = torch.arange(s, min(s + CHUNK, n), device=device) // reps
        blk = base[rows]
        noise = torch.rand(blk.shape, generator=g, device=device)
        mask = torch.rand(blk.shape, generator=g, device=device) \
            < p["frac_features"]
        out[s:s + len(rows)] = torch.where(mask, noise, blk)
    perm = torch.randperm(n, generator=g, device=device)
    x_test, y_test = envelope(generator(test_seed, device), means, bases,
                              p["n_test"], device)
    return Data(x=out[perm], y=y.repeat_interleave(reps)[perm],
                x_test=x_test, y_test=y_test)
