"""The exact mini-batch kernel k-means path (paper Alg.1) in PyTorch."""
from .engine import GramEngine, resolve_engine
from .kernels import KernelSpec, gamma_from_dmax
from .kkmeans import kkmeans_fit, kkmeans_fit_full, kkmeans_fit_gram, medoid_indices
from .metrics import clustering_accuracy, nmi
from .minibatch import (FitResult, GlobalState, MiniBatchConfig, fit,
                        fit_dataset, predict)

__all__ = [
    "FitResult", "GlobalState", "GramEngine", "KernelSpec", "MiniBatchConfig",
    "clustering_accuracy", "fit", "fit_dataset", "gamma_from_dmax",
    "kkmeans_fit", "kkmeans_fit_full", "kkmeans_fit_gram", "medoid_indices",
    "nmi", "predict", "resolve_engine",
]
