"""Quickstart of the PyTorch port: approximate kernel k-means on the
paper's 2D toy dataset.

    PYTHONPATH=src python examples/torch_quickstart.py               # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The port of ``examples/quickstart.py``: MiniBatchConfig's knobs (B, s),
fitting, prediction and the accuracy / NMI metrics, and the kernel method
beating linear k-means (``repro_torch.baselines``) on a set no line
separates (XOR blobs). On the card the fits run the hand-written
assign_fused and kernel_matrix kernels; on the CPU their plain versions.
``main`` returns the printed numbers.
"""
import argparse

import numpy as np

from repro_torch.baselines import lloyd_kmeans
from repro_torch.core import (KernelSpec, MiniBatchConfig,
                              clustering_accuracy, fit_dataset, nmi)
from repro_torch.core.minibatch import predict
from repro_torch.data.synthetic import toy2d
from repro_torch.device import resolve_device


def xor_blobs(n_per=500, seed=0):
    """XOR arrangement: class 0 at (+,+)/(-,-), class 1 at (+,-)/(-,+).
    No line separates the classes, but the degree-2 polynomial kernel's
    feature map contains x1*x2, which does."""
    rng = np.random.default_rng(seed)
    c = np.array([[2, 2], [-2, -2], [2, -2], [-2, 2]], np.float32)
    x = np.concatenate([rng.normal(ci, 0.5, (n_per, 2)) for ci in c])
    y = np.array([0] * n_per * 2 + [1] * n_per * 2, np.int32)
    perm = rng.permutation(len(x))
    return x[perm].astype(np.float32), y[perm]


def _labels(x, res, spec, dev):
    return predict(x, res.state.medoids, res.state.medoid_diag, spec=spec,
                   device=dev).cpu().numpy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}

    # ---- the paper's 2D toy: 4 gaussians, B = 3 mini-batches --------------
    x, y = toy2d(n_per_cluster=2500)
    cfg = MiniBatchConfig(n_clusters=4, n_batches=3, s=1.0,
                          kernel=KernelSpec("rbf", gamma=4.0),
                          sampling="stride", seed=0)
    res = fit_dataset(x, cfg, device=dev)
    labels = _labels(x, res, cfg.kernel, dev)
    out["toy_acc"] = clustering_accuracy(y, labels)
    out["toy_nmi"] = nmi(y, labels)
    print(f"2D toy     | kernel k-means (B=3):   acc={out['toy_acc']:.3f} "
          f"nmi={out['toy_nmi']:.3f}  inner iters/batch="
          f"{[h.inner_iters for h in res.history]}")

    # ---- sparse centroids: s = 0.2 (5x fewer kernel evaluations) ---------
    cfg_s = MiniBatchConfig(n_clusters=4, n_batches=3, s=0.2,
                            kernel=KernelSpec("rbf", gamma=4.0), seed=0)
    res_s = fit_dataset(x, cfg_s, device=dev)
    labels_s = _labels(x, res_s, cfg_s.kernel, dev)
    out["sparse_acc"] = clustering_accuracy(y, labels_s)
    out["sparse_nmi"] = nmi(y, labels_s)
    print(f"2D toy     | sparse landmarks (s=.2): acc="
          f"{out['sparse_acc']:.3f} nmi={out['sparse_nmi']:.3f}")

    # ---- XOR: kernel vs linear --------------------------------------------
    xr, yr = xor_blobs()
    lin = lloyd_kmeans(xr, 2, n_init=5, device=dev)
    out["xor_linear_acc"] = clustering_accuracy(yr, lin.labels.cpu().numpy())
    spec = KernelSpec("polynomial", gamma=0.25, coef0=0.0, degree=2)
    cfg_r = MiniBatchConfig(n_clusters=2, n_batches=1, s=1.0, kernel=spec,
                            seed=0)
    res_r = fit_dataset(xr, cfg_r, device=dev)
    out["xor_kernel_acc"] = clustering_accuracy(yr, _labels(xr, res_r, spec,
                                                            dev))
    print(f"XOR blobs  | linear k-means (C=2):    "
          f"acc={out['xor_linear_acc']:.3f}")
    print(f"XOR blobs  | poly-2 kernel k-means:   "
          f"acc={out['xor_kernel_acc']:.3f}   <- non-linear win")
    return out


if __name__ == "__main__":
    main()
