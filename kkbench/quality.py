"""Normalized mutual information (paper §4), a copy of
``repro_torch.core.metrics.nmi``: the quality the ``nmi`` metric reports,
between the generator's labels and the program's."""
from __future__ import annotations

import numpy as np


def nmi(labels_true, labels_pred) -> float:
    t = np.asarray(labels_true).astype(np.int64)
    p = np.asarray(labels_pred).astype(np.int64)
    o = np.zeros((p.max() + 1, t.max() + 1), dtype=np.float64)
    np.add.at(o, (p, t), 1)
    n = o.sum()
    if n == 0:
        return 0.0
    pi, pj = o.sum(axis=1), o.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        num = o * np.log((n * o) / np.outer(pi, pj))
    mi = np.nansum(num) / n
    hu = -np.sum((pi[pi > 0] / n) * np.log(pi[pi > 0] / n))
    hy = -np.sum((pj[pj > 0] / n) * np.log(pj[pj > 0] / n))
    denom = np.sqrt(hu * hy)
    return float(mi / denom) if denom > 0 else 0.0
