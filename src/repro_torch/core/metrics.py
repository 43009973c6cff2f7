"""Clustering quality measures (paper §4), numpy copies of
``repro/core/metrics.py``: accuracy through the majority-vote mapping,
normalized mutual information, the elbow criterion and the medoid
displacement."""
from __future__ import annotations

import numpy as np


def contingency(labels_true, labels_pred, n_true: int | None = None,
                n_pred: int | None = None) -> np.ndarray:
    """o_{i,j} = #{k : u_k = i and y_k = j}   (rows = predicted clusters)."""
    labels_true = np.asarray(labels_true).astype(np.int64)
    labels_pred = np.asarray(labels_pred).astype(np.int64)
    nt = int(n_true if n_true is not None else labels_true.max() + 1)
    npred = int(n_pred if n_pred is not None else labels_pred.max() + 1)
    o = np.zeros((npred, nt), dtype=np.int64)
    np.add.at(o, (labels_pred, labels_true), 1)
    return o


def clustering_accuracy(labels_true, labels_pred) -> float:
    """mu(y, u) with the paper's majority-voting cluster->class mapping."""
    o = contingency(labels_true, labels_pred)
    return float(o.max(axis=1).sum() / max(len(np.asarray(labels_true)), 1))


def nmi(labels_true, labels_pred) -> float:
    """Normalized mutual information, NMI(y, u) (paper §4 definition)."""
    o = contingency(labels_true, labels_pred).astype(np.float64)
    n = o.sum()
    if n == 0:
        return 0.0
    pi = o.sum(axis=1)
    pj = o.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        num = o * np.log((n * o) / np.outer(pi, pj))
    mi = np.nansum(num) / n
    hu = -np.sum((pi[pi > 0] / n) * np.log(pi[pi > 0] / n))
    hy = -np.sum((pj[pj > 0] / n) * np.log(pj[pj > 0] / n))
    denom = np.sqrt(hu * hy)
    return float(mi / denom) if denom > 0 else 0.0


def elbow(costs) -> int:
    """The elbow criterion (paper §4.4, §4.5): the index of the largest
    positive second difference of the cost-against-C curve (0 below three
    points)."""
    c = np.asarray(costs, dtype=np.float64)
    if len(c) < 3:
        return 0
    d2 = c[:-2] - 2 * c[1:-1] + c[2:]
    return int(np.argmax(d2) + 1)


def mean_displacement(history) -> np.ndarray:
    """Mean medoid displacement of each outer iteration (the Fig.4b
    observable): small and flat when the sampling represents the data,
    spikes under drift (block sampling over a drifting stream)."""
    return np.asarray([float(np.mean(h.displacement)) for h in history])
