"""The exact mini-batch kernel k-means path (paper Alg.1) in PyTorch, and
the memory planner."""
from .engine import GramEngine, resolve_engine
from .init import assign_to_medoids, kmeans_pp_indices
from .kernels import KernelSpec, gamma_from_dmax
from .kkmeans import kkmeans_fit, kkmeans_fit_full, kkmeans_fit_gram, medoid_indices
from .landmarks import choose_landmarks, num_landmarks, select_landmark_indices
from .memory import (MachineSpec, Plan, b_min, b_min_paper,
                     embed_footprint_bytes, engine_footprint_bytes,
                     footprint_bytes, host_staging_bytes, plan,
                     predicted_accuracy, s_step_state_bytes,
                     selector_footprint_bytes, serve_footprint_bytes,
                     sketch_footprint_bytes)
from .metrics import clustering_accuracy, elbow, mean_displacement, nmi
from .minibatch import (FitResult, GlobalState, MiniBatchConfig, fit,
                        fit_dataset, predict)

__all__ = [
    "FitResult", "GlobalState", "GramEngine", "KernelSpec", "MiniBatchConfig",
    "assign_to_medoids", "choose_landmarks", "clustering_accuracy", "elbow",
    "fit", "mean_displacement",
    "fit_dataset", "gamma_from_dmax", "kkmeans_fit", "kkmeans_fit_full",
    "kkmeans_fit_gram", "kmeans_pp_indices", "medoid_indices", "nmi",
    "num_landmarks", "predict", "resolve_engine", "select_landmark_indices",
    "MachineSpec", "Plan", "b_min", "b_min_paper", "embed_footprint_bytes",
    "engine_footprint_bytes", "footprint_bytes", "host_staging_bytes",
    "plan", "predicted_accuracy", "s_step_state_bytes",
    "selector_footprint_bytes", "serve_footprint_bytes",
    "sketch_footprint_bytes",
]
