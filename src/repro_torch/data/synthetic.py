"""Synthetic datasets matched to the paper's §4 data, numpy copies of
``repro/data/synthetic.py`` (same seeds, same arrays). Every generator
returns (X float32 [n, d], y int32 [n]); ``make_rcv1_sparse`` returns X as
a ``CSRBatch`` of CPU tensors."""
from __future__ import annotations

import numpy as np


def toy2d(n_per_cluster: int = 10000, seed: int = 0):
    """The paper's 2D toy: 4 isotropic gaussians, sigma=0.2, on a grid."""
    rng = np.random.default_rng(seed)
    centers = np.array([[0.25, 0.25], [0.25, 0.75], [0.75, 0.25], [0.75, 0.75]])
    xs, ys = [], []
    for j, c in enumerate(centers):
        xs.append(rng.normal(c, 0.2, size=(n_per_cluster, 2)))
        ys.append(np.full(n_per_cluster, j))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    perm = rng.permutation(len(x))
    return x[perm], y[perm]


def make_blobs(n: int, d: int, n_classes: int, *, sep: float = 6.0,
               sigma: float = 1.0, seed: int = 0):
    """Gaussian mixture with controllable separation."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, sep / np.sqrt(d), size=(n_classes, d))
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    x = centers[y] + rng.normal(0.0, sigma / np.sqrt(d), size=(n, d))
    return x.astype(np.float32), y


def make_mnist_like(n: int = 60000, seed: int = 0):
    """MNIST envelope: 784-d, 10 classes; each class a rank-16 affine
    manifold plus pixel noise, clipped to [0, 1]."""
    d, n_classes, r = 784, 10, 16
    rng = np.random.default_rng(seed)
    x = np.empty((n, d), np.float32)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    for j in range(n_classes):
        idx = np.where(y == j)[0]
        mean = rng.uniform(0.0, 0.6, size=d) * (rng.random(d) < 0.25)
        basis = rng.normal(0.0, 1.0, size=(r, d)) / np.sqrt(d)
        z = rng.normal(0.0, 1.0, size=(len(idx), r))
        x[idx] = mean + z @ basis + rng.normal(0, 0.05, size=(len(idx), d))
    return np.clip(x, 0.0, 1.0), y


def make_rcv1_like(n: int = 188000, d: int = 256, n_classes: int = 50,
                   seed: int = 0):
    """RCV1 envelope after the paper's preprocessing: log TF-IDF vectors
    random-projected to a dense 256-d space; ~50 categories with a power-law
    class-size distribution."""
    rng = np.random.default_rng(seed)
    sizes = (1.0 / np.arange(1, n_classes + 1)) ** 1.1
    sizes = np.maximum((sizes / sizes.sum() * n).astype(np.int64), 1)
    sizes[0] += n - sizes.sum()
    y = np.repeat(np.arange(n_classes), sizes).astype(np.int32)
    # sparse topic vectors in a 2048-d "vocab", projected to d dense dims
    vocab = 2048
    proj = rng.normal(0.0, 1.0 / np.sqrt(d), size=(vocab, d)).astype(np.float32)
    x = np.empty((n, d), np.float32)
    for j in range(n_classes):
        idx = np.where(y == j)[0]
        topic = rng.random(vocab) < (32.0 / vocab)
        base = rng.exponential(1.0, size=vocab) * topic
        docs = rng.poisson(lam=base, size=(len(idx), vocab)).astype(np.float32)
        docs *= rng.random((len(idx), vocab)) < 0.3       # per-doc word dropout
        docs = np.log1p(docs)
        norms = np.linalg.norm(docs, axis=1, keepdims=True)
        x[idx] = (docs / np.maximum(norms, 1e-9)) @ proj
    perm = rng.permutation(n)
    return x[perm], y[perm]


def make_rcv1_sparse(n: int = 188000, vocab: int = 20000,
                     n_classes: int = 50, *, words_per_topic: float = 48.0,
                     seed: int = 0):
    """RCV1 before the paper's dense 256-d projection: log TF-IDF documents
    kept sparse over a ``vocab``-dimensional term space (tens of nonzeros a
    document, heavy-tailed class sizes) -> (CSRBatch [n, vocab], y int32
    [n]), the reference's arrays bit for bit."""
    import torch

    from .sparse import CSRBatch

    rng = np.random.default_rng(seed)
    sizes = (1.0 / np.arange(1, n_classes + 1)) ** 1.1
    sizes = np.maximum((sizes / sizes.sum() * n).astype(np.int64), 1)
    sizes[0] += n - sizes.sum()
    y = np.repeat(np.arange(n_classes), sizes).astype(np.int32)

    datas, cols, lens = [], [], []
    for j in range(n_classes):
        n_j = int(sizes[j])
        topic = np.where(rng.random(vocab) < (words_per_topic / vocab))[0]
        if len(topic) == 0:
            topic = rng.integers(0, vocab, size=8)
        base = rng.exponential(1.0, size=len(topic))
        counts = rng.poisson(lam=base, size=(n_j, len(topic)))
        counts = counts * (rng.random((n_j, len(topic))) < 0.5)
        vals = np.log1p(counts.astype(np.float32))
        norms = np.sqrt((vals ** 2).sum(axis=1, keepdims=True))
        vals = vals / np.maximum(norms, 1e-9)
        for r in range(n_j):
            nz = np.nonzero(vals[r])[0]
            datas.append(vals[r, nz])
            cols.append(topic[nz])
            lens.append(len(nz))

    perm = rng.permutation(n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.asarray(lens)[perm], out=indptr[1:])
    data = np.concatenate([datas[i] for i in perm]).astype(np.float32)
    indices = np.concatenate([cols[i] for i in perm]).astype(np.int32)
    batch = CSRBatch(torch.from_numpy(data), torch.from_numpy(indices),
                     torch.from_numpy(indptr.astype(np.int32)), (n, vocab))
    return batch, y[perm]


def make_noisy_replicas(x: np.ndarray, y: np.ndarray, *, n_replicas: int = 20,
                        frac_features: float = 0.2, seed: int = 0):
    """The paper's 'Noisy MNIST': each sample perturbed ``n_replicas`` times
    with uniform noise on ``frac_features`` of the features (§4, 1.2M
    samples)."""
    rng = np.random.default_rng(seed)
    n, d = x.shape
    out_x = np.repeat(x, n_replicas, axis=0)
    out_y = np.repeat(y, n_replicas, axis=0)
    k = int(frac_features * d)
    cols = rng.integers(0, d, size=(len(out_x), k))
    rows = np.arange(len(out_x))[:, None]
    out_x[rows, cols] = rng.random((len(out_x), k)).astype(x.dtype)
    perm = rng.permutation(len(out_x))
    return out_x[perm], out_y[perm]


def make_md_trajectory(n_frames: int = 100000, n_atoms: int = 64,
                       n_states: int = 20, *, dwell: float = 500.0,
                       seed: int = 0):
    """The MD-trajectory envelope (§4.5): a Markov jump process over
    metastable conformations. Frames are 3 n_atoms coordinates fluctuating
    around one of ``n_states`` reference structures; consecutive frames are
    correlated (mean dwell time ``dwell`` frames), the concept-drift regime
    where block sampling struggles and stride sampling does not (Fig.4)."""
    rng = np.random.default_rng(seed)
    d = 3 * n_atoms
    refs = rng.normal(0.0, 1.0, size=(n_states, d)).astype(np.float32)
    y = np.empty(n_frames, np.int32)
    state = 0
    for t in range(n_frames):
        if rng.random() < 1.0 / dwell:
            state = rng.integers(0, n_states)
        y[t] = state
    x = refs[y] + rng.normal(0.0, 0.15, size=(n_frames, d)).astype(np.float32)
    return x, y
