"""Mini-batch Lloyd in an explicit feature space, the port of
``repro/approx/embed_kmeans.py``.

With an explicit map z = phi_m(x) (RFF, Nystrom or a sketch), kernel
k-means becomes linear k-means on Z: centroids are real [C, m] vectors, the
batch centroids are exact cluster means, and the Eq.12 merge

    c_j <- (1 - a) c_j + a c_j^i,   a = |w_j^i| / (|w_j^i| + |w_j|)

is computed exactly. An empty batch cluster (a = 0) keeps its global
centroid, as on the exact path.

Each batch is embedded once and stays resident for the inner loop, whose
sweeps are plain PyTorch products. A CSR batch is embedded by the sketch
maps' O(nnz) path (``approx/sketch.py``). The reference's ``lax.while_loop`` is a
Python loop here, as in ``core/kkmeans.py``: one host sync per iteration,
each iteration an ``obs:sweep`` span and its read an
``obs:host_read[changed]`` span.
Prediction of dense rows goes through the fused ``embed_assign`` /
``sketch_assign`` kernels (``kernels/ops.embed_assign``), where Z never
reaches device memory; CSR rows are embedded by the map's O(nnz) path and
assigned in plain PyTorch, as in the reference (the kernels take dense row
tiles).

Randomness: batch 0's k-means++ draw comes from the CPU generator of batch
0 (``core.minibatch.batch_generator``) and is split out (``draw_first``),
so tests can inject the reference's seeds into ``_first_batch_step``.

``recorder=`` (``repro_torch.obs``) logs per batch the Lloyd cost (the
tensor, drained at the boundary) and iterations, the wall seconds, the
empty clusters and an allocator watermark beside the predicted bytes, all
on the host between batches.
"""
from __future__ import annotations

import time
from typing import Callable, Iterable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.analysis.dispatch import iteration, loop
from repro_torch.core.init import kmeans_pp_indices
from repro_torch.core.kernels import KernelSpec
from repro_torch.data.loader import closing_source, to_device
from repro_torch.data.sparse import is_sparse
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ops import BIG
from repro_torch.kernels.precision import resolve_precision
from repro_torch.obs.trace import batch_spans, span

from .sketch import check_dense

_LINEAR = KernelSpec("linear")


class EmbedState(NamedTuple):
    """O(C*m) cross-batch state of the embedded outer loop."""
    centroids: torch.Tensor      # [C, m] explicit feature-space centroids
    cardinalities: torch.Tensor  # [C] accumulated |w_j| (f32)
    batches_done: int


class EmbedInnerResult(NamedTuple):
    labels: torch.Tensor         # [n] int32
    centroids: torch.Tensor      # [C, m] batch cluster means
    counts: torch.Tensor         # [C]
    n_iter: int
    cost: torch.Tensor           # sum_i |z_i - c_{u_i}|^2 at the fixpoint


def assign_embedded(z: torch.Tensor, centroids: torch.Tensor,
                    counts: Optional[torch.Tensor] = None, *,
                    precision: str = "f32"):
    """Nearest-centroid labels and squared distances in embedded space ->
    (labels [n] int32, d2 [n] f32). Clusters with ``counts == 0`` are
    unjoinable (+1e30). ``precision`` rounds z to the tile dtype first;
    the centroids stay f32."""
    z = resolve_precision(precision).cast_tiles(z).to(torch.float32)
    c = centroids.to(torch.float32)
    zsq = torch.sum(z * z, dim=1)
    csq = torch.sum(c * c, dim=1)
    d2 = torch.clamp(zsq[:, None] + csq[None, :] - 2.0 * (z @ c.T), min=0.0)
    if counts is not None:
        d2 = torch.where(counts[None, :] > 0, d2, torch.full_like(d2, BIG))
    return torch.argmin(d2, dim=1).to(torch.int32), torch.amin(d2, dim=1)


def _means(z: torch.Tensor, labels: torch.Tensor, n_clusters: int):
    h = F.one_hot(labels.long(), n_clusters).to(torch.float32)   # [n, C]
    counts = torch.sum(h, dim=0)
    sums = h.T @ z.to(torch.float32)                              # [C, m]
    return sums / torch.clamp(counts, min=1.0)[:, None], counts


def lloyd_fit(z: torch.Tensor, labels0: torch.Tensor, *, n_clusters: int,
              max_iters: int = 100) -> EmbedInnerResult:
    """Lloyd's iteration on the embedded rows ``z`` [n, m] to its label
    fixpoint (or ``max_iters``)."""
    labels = labels0.to(torch.int32)
    changed, t = True, 0
    cost = torch.tensor(float("inf"), device=z.device)
    with loop("lloyd"):
        while changed and t < max_iters:
            with span("obs:sweep"):
                iteration()
                cents, counts = _means(z, labels, n_clusters)
                new_labels, mind = assign_embedded(z, cents, counts)
                moved = torch.any(new_labels != labels)
                with span("obs:host_read[changed]"):
                    changed = bool(moved)                       # host sync
                labels, t, cost = new_labels, t + 1, torch.sum(mind)
    cents, counts = _means(z, labels, n_clusters)
    return EmbedInnerResult(labels, cents, counts, t, cost)


def draw_first(z: torch.Tensor, gen: torch.Generator, *,
               n_clusters: int) -> torch.Tensor:
    """Batch 0's draw: k-means++ seed indices on the embedded rows (the
    linear kernel is the embedded space's)."""
    diag = torch.sum(z.to(torch.float32) ** 2, dim=1)
    return kmeans_pp_indices(z, diag, gen, n_clusters=n_clusters,
                             spec=_LINEAR)


def _first_batch_step(z: torch.Tensor, seeds: torch.Tensor, *,
                      n_clusters: int, max_iters: int):
    """Batch 0: labels from the seeds, Lloyd, the first state."""
    with span("obs:eq8"):
        labels0, _ = assign_embedded(z, z[seeds])
    res = lloyd_fit(z, labels0, n_clusters=n_clusters, max_iters=max_iters)
    return EmbedState(res.centroids, res.counts, 1), res


def _next_batch_step(z: torch.Tensor, state: EmbedState, *, n_clusters: int,
                     max_iters: int):
    """Batch i > 0: warm start from the global centroids, Lloyd, merge."""
    with span("obs:eq8"):
        labels0, _ = assign_embedded(z, state.centroids, state.cardinalities)
    res = lloyd_fit(z, labels0, n_clusters=n_clusters, max_iters=max_iters)
    with span("obs:merge"):
        alpha = res.counts / torch.clamp(res.counts + state.cardinalities,
                                         min=1.0)
        merged = ((1.0 - alpha)[:, None] * state.centroids
                  + alpha[:, None] * res.centroids)
        keep = (res.counts == 0)[:, None]
        new_centroids = torch.where(keep, state.centroids, merged)
        disp = torch.sum((new_centroids - state.centroids) ** 2, dim=1)
        new_state = EmbedState(new_centroids,
                               state.cardinalities + res.counts,
                               state.batches_done + 1)
    return new_state, res, disp


def fit_embedded(batches: Iterable, fmap, *, n_clusters: int,
                 max_iters: int = 100, seed: int = 0,
                 state: Optional[EmbedState] = None,
                 checkpoint_cb: Optional[Callable[[EmbedState, int], None]] = None,
                 recorder=None, precision: str = "f32", device=None):
    """The embedded outer loop -> (EmbedState, [BatchStats]). Each batch
    (dense rows, or a CSR batch for the sketch maps) is embedded once and
    rounded ONCE to the tile dtype (``precision``), which under bf16 halves
    the resident [n, m] batch; every sum stays f32. ``checkpoint_cb(state,
    i)`` runs after every merged batch. Consumes ``batches``: a closable
    source (``data.loader.BatchSource``) is closed on exit, success or
    failure. ``recorder``: see the module docstring."""
    with closing_source(batches):
        return _fit_embedded_loop(batches, fmap, n_clusters=n_clusters,
                                  max_iters=max_iters, seed=seed,
                                  state=state, checkpoint_cb=checkpoint_cb,
                                  recorder=recorder, precision=precision,
                                  device=device)


def _fit_embedded_loop(batches, fmap, *, n_clusters, max_iters, seed, state,
                       checkpoint_cb, recorder, precision, device):
    from repro_torch.core.minibatch import batch_generator, batch_stats
    from repro_torch.obs import memory as obs_memory
    from repro_torch.obs import resolve as resolve_recorder

    rec = resolve_recorder(recorder)
    dev = resolve_device(device)
    prec = resolve_precision(precision)
    if state is not None:
        state = EmbedState(state.centroids.to(dev),
                           state.cardinalities.to(dev), state.batches_done)
    history: list = []
    start = state.batches_done if state is not None else 0
    for i, xb in batch_spans(batches, start):
        t_batch = time.perf_counter()
        check_dense(fmap.kind, xb)
        with span("obs:stage"):
            xb = to_device(xb, dev)
        sparse = is_sparse(xb)
        with span("obs:embed_phi"):
            z = prec.cast_tiles(fmap(xb))
        if state is None:
            seeds = draw_first(z, batch_generator(seed, i),
                               n_clusters=n_clusters)
            state, res = _first_batch_step(z, seeds, n_clusters=n_clusters,
                                           max_iters=max_iters)
            disp = None
        else:
            state, res, disp = _next_batch_step(z, state,
                                                n_clusters=n_clusters,
                                                max_iters=max_iters)
        rec.series("inner/cost", res.cost, batch=i)     # drained later
        rec.series("inner/iters", res.n_iter, batch=i)
        history.append(batch_stats(res, disp))
        if checkpoint_cb is not None:
            checkpoint_cb(state, i)
        if rec.enabled:
            n_rows, d = xb.shape
            rec.series("batch/wall_seconds", time.perf_counter() - t_batch,
                       batch=i, rows=n_rows)
            rec.gauge("clusters/empty",
                      int((history[-1].counts == 0).sum()), batch=i)
            density = (xb.nnz / max(n_rows * d, 1)) if sparse else 1.0
            obs_memory.watermark(
                rec, batch=i, device=dev, predicted_bytes=(
                    obs_memory.predicted_embed_footprint(
                        n_rows, n_clusters, fmap, sparse=sparse,
                        density=density)))
            rec.batch_boundary(i)
    if state is None:
        raise ValueError("empty batch iterable")
    return state, history


def predict_embedded(x, state: EmbedState, fmap, *,
                     use_fused: Optional[bool] = None,
                     precision: str = "f32", device=None) -> torch.Tensor:
    """Label rows by nearest centroid in embedded space -> [n] int32.

    A CSR batch (sketch maps only) takes ``assign_embedded(fmap(x), ...)``
    with the map's O(nnz) embedding, as in the reference. For dense rows
    the default is the fused path (``kernels/ops.embed_assign``: the
    ``embed_assign`` or ``sketch_assign`` kernel on the card), where the
    embedded rows never reach device memory; it raises ``ValueError`` for
    a Nystrom map over a kind without an in-tile epilogue (laplacian), as
    the reference's fused path does. ``use_fused=False`` is the explicit
    materialized path ``assign_embedded(fmap(x), ...)``."""
    check_dense(fmap.kind, x)
    dev = resolve_device(device)
    x = to_device(x, dev)
    if is_sparse(x):
        labels, _ = assign_embedded(fmap(x), state.centroids,
                                    state.cardinalities, precision=precision)
        return labels
    if use_fused is not False:
        labels, _ = ops.embed_assign(x, fmap, state.centroids,
                                     state.cardinalities, precision=precision)
        return labels
    labels, _ = assign_embedded(fmap(x), state.centroids,
                                state.cardinalities, precision=precision)
    return labels

