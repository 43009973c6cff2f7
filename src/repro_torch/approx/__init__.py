"""Explicit feature maps that turn kernel k-means into linear k-means, the
port of ``repro/approx``.

Every map has ``dim`` (embedding width m), ``in_dim`` (d), ``kind`` and
``__call__`` (rows -> [n, m] f32), so the embedded outer loop,
``FitResult.predict`` and the fused kernels (``kernels/ops.embed_assign``)
do not care which map they hold; ``core.minibatch`` dispatches on
``MiniBatchConfig.method``:

* ``rff`` (+ ``rff_orthogonal``): random Fourier features, rbf only;
* ``nystrom``: landmark embedding, any Mercer kernel; its landmarks come
  from a selector (``selectors``: uniform, rls, kpp);
* ``sketch``: count-sketch, linear kernel;
* ``tensorsketch``: FFT composition of count-sketches, polynomial kernel.

The two sketch maps also embed CSR batches (``data/sparse.py``) in O(nnz);
RFF and Nystrom need dense rows and refuse a CSR batch.

Maps are drawn from a CPU ``torch.Generator`` and their tables moved to the
sample's device, so CPU and GPU fits of one seed draw the same map.
"""
from __future__ import annotations

import torch

from repro_torch.data.sparse import as_csr, is_sparse

from .embed_kmeans import (EmbedInnerResult, EmbedState, assign_embedded,
                           fit_embedded, lloyd_fit, predict_embedded)
from .nystrom import (NystromMap, make_nystrom, nystrom_features,
                      nystrom_from_landmarks, whiten_gram)
from .rff import RFFMap, make_rff, rff_features
from . import selectors
from .selectors import (KPPSelector, LandmarkSelector, RLSSelector,
                        SelectorState, UniformSelector, select_streaming)
from .sketch import (CountSketchMap, TensorSketchMap, check_dense,
                     count_sketch_features, count_sketch_features_csr,
                     make_count_sketch, make_tensor_sketch,
                     tensor_sketch_features, tensor_sketch_features_csr)

METHODS = ("rff", "nystrom", "sketch", "tensorsketch")


def default_embed_dim(n_clusters: int) -> int:
    """m = 4*C, the reference's default."""
    return 4 * n_clusters


def make_feature_map(method: str, gen: torch.Generator, x_sample, m: int,
                     spec, *, orthogonal: bool = False, selector=None):
    """Build a feature map from a sample (the first mini-batch) with the
    CPU generator ``gen``; the map's tables live on the sample's device.
    The sketch maps read only the sample's column count, so their sample
    may be a CSR batch; RFF and Nystrom refuse one, as in the reference.
    ``selector`` picks Nystrom's landmark rows; the other maps have none,
    so a non-uniform selector with them is rejected rather than ignored."""
    if method != "nystrom" and selectors.name_of(selector) != "uniform":
        raise ValueError(
            f"selector {selectors.name_of(selector)!r} only applies to "
            f"landmark-based maps (method 'nystrom', or the exact path); "
            f"method {method!r} is data-oblivious")
    if is_sparse(x_sample):
        x_sample = as_csr(x_sample)
    d, dev = x_sample.shape[1], x_sample.device
    if method == "sketch":
        return make_count_sketch(gen, d, m, spec, device=dev)
    if method == "tensorsketch":
        return make_tensor_sketch(gen, d, m, spec, device=dev)
    check_dense(method, x_sample)
    if method == "rff":
        return make_rff(gen, d, m, spec, orthogonal=orthogonal, device=dev)
    if method == "nystrom":
        return make_nystrom(gen, x_sample, m, spec, selector=selector)
    raise ValueError(f"unknown feature-map method {method!r}; have {METHODS}")


__all__ = [
    "METHODS", "default_embed_dim", "make_feature_map",
    "RFFMap", "make_rff", "rff_features",
    "NystromMap", "make_nystrom", "nystrom_features",
    "nystrom_from_landmarks", "whiten_gram",
    "CountSketchMap", "make_count_sketch", "count_sketch_features",
    "count_sketch_features_csr",
    "TensorSketchMap", "make_tensor_sketch", "tensor_sketch_features",
    "tensor_sketch_features_csr",
    "LandmarkSelector", "UniformSelector", "RLSSelector", "KPPSelector",
    "SelectorState", "select_streaming", "selectors",
    "EmbedState", "EmbedInnerResult", "assign_embedded", "fit_embedded",
    "lloyd_fit", "predict_embedded",
]
