"""Mini-batch kernel k-means outer loop (paper §3.1, Alg.1), the port of
``repro/core/minibatch.py``.

Per mini-batch i:
  1. fetch X^i (stride or block sampling — ``data/sampling.py``);
  2. draw the landmarks (and, for i = 0, the k-means++ seeds);
  3. initialize labels: k-means++ seeds (i = 0) or the nearest global medoid
     through the auxiliary matrix K~^i (Eq.8);
  4. run the inner loop to its label fixpoint over the GramEngine;
  5. take the batch medoids (Eq.7/10);
  6. merge them into the global medoids by the convex combination
     w_j <- (1-a) phi(m_j) + a phi(m_j^i), a = |w_j^i| / (|w_j^i| + |w_j|),
     re-approximated on the batch (Eq.12); an empty batch cluster (a = 0)
     leaves its global medoid untouched.

Randomness: batch i draws from a CPU ``torch.Generator`` seeded from
(seed, i) alone, and its indices then move to the device. A resumed fit
draws the same landmarks as an uninterrupted one, and CPU and GPU runs draw
the same ones. Each batch step is split into the draw (``draw_first``,
``draw_next``) and a deterministic function of the batch, the draws and the
previous state (``_first_batch_step``, ``_next_batch_step``).

``method="rff"|"nystrom"|"sketch"|"tensorsketch"`` runs the loop in an
explicit m-dimensional feature space instead (``repro_torch.approx``): the
map is drawn from the first batch with a CPU generator of ``seed`` alone
(``map_generator``), every batch is embedded once, the inner loop is plain
Lloyd, and ``FitResult.predict`` labels through the serving bucket ladder
(``serving.assign.predict``) and the fused ``embed_assign`` /
``sketch_assign`` kernels. The sketch methods also take CSR mini-batches
(``data/sparse.py``), embedded in O(nnz); the exact method refuses them.

Ingestion: ``fit`` consumes any iterable of batches or a
``data.loader.BatchSource`` (closed on exit, success or failure), and
``fit_dataset`` splits a resident dataset, dense or CSR, into a source
that stages in the consumer with the plain copy (``to_device``): on the
card a producer thread made these fits no faster
(``launch/ingest_bench.py``). A stream takes ``prefetch=``, and its
producer thread stages through pinned memory on a copy stream. A
resumed fit skips the committed batches host-side (``BatchSource.skip``)
and passes ``state=`` (and ``fmap=``).

``recorder=`` (``repro_torch.obs``) is the flight recorder: per batch the
inner cost (the tensor, drained at the boundary) and iterations, the wall
seconds, the empty clusters, the mean medoid displacement and an
allocator watermark beside the planner's predicted bytes. Every hook runs
on the host between batches, outside the inner loop, and reads no tensor
before the batch boundary.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Iterable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.data.loader import BatchSource, closing_source, to_device
from repro_torch.data.sparse import is_sparse
from repro_torch.device import resolve_device
from repro_torch.obs import batch_spans, span
from repro_torch.obs import memory as obs_memory
from repro_torch.obs import resolve as resolve_recorder

from .engine import GramEngine, resolve_engine
from .init import assign_to_medoids, kmeans_pp_indices
from .kernels import KernelSpec
from .kkmeans import InnerResult, kkmeans_fit, medoid_indices
from .landmarks import check_selector, num_landmarks, select_landmark_indices


@dataclasses.dataclass(frozen=True)
class MiniBatchConfig:
    n_clusters: int
    n_batches: int = 1                   # B
    s: float = 1.0                       # landmark fraction (Eq.18)
    kernel: KernelSpec = KernelSpec("rbf", gamma=1.0)
    max_inner_iters: int = 100
    sampling: str = "stride"             # "stride" | "block"
    seed: int = 0
    restrict_medoids_to_members: bool = False  # Eq.7 is unrestricted
    landmark_multiple_of: int = 1        # |L| alignment of the mesh
    # "exact" | "rff" | "nystrom" | "sketch" | "tensorsketch"
    method: str = "exact"
    embed_dim: int = 0                   # m; 0 -> approx.default_embed_dim(C)
    rff_orthogonal: bool = False         # ORF variant (lower variance)
    # landmark selection (approx.selectors): "uniform" | "rls" | "kpp" or a
    # LandmarkSelector; for the paths that pick landmark rows, "exact"
    # (Eq.14) and "nystrom" (the map's landmarks)
    selector: object = "uniform"
    # Gram residency of the inner loop: "materialize" | "fused" | "tiled"
    # or a GramEngine (core/engine.py)
    engine: object = "materialize"
    precision: str = "f32"               # tile dtype: "f32" | "bf16"
    # Lloyd refinements per global sync of the mesh's exact inner loop
    # (distributed.inner.DistributedInnerConfig.s_step); a single-host fit
    # ignores it
    s_step: int = 1

    _METHODS = ("exact", "rff", "nystrom", "sketch", "tensorsketch")

    def __post_init__(self):
        if self.s_step < 1:
            raise ValueError(f"s_step must be >= 1, got {self.s_step}")
        if self.method not in self._METHODS:
            raise ValueError(
                f"method must be one of {self._METHODS}, got {self.method!r}")
        name = check_selector(self.selector)
        if name != "uniform" and self.method not in ("exact", "nystrom"):
            raise ValueError(
                f"selector {name!r} only applies to landmark-based "
                f"methods ('exact', 'nystrom'); method {self.method!r} has "
                f"no landmarks")
        eng = dataclasses.replace(resolve_engine(self.engine, self.precision),
                                  precision="f32")
        if eng != GramEngine() and self.method != "exact":
            raise ValueError(
                f"engine {eng.mode!r} only applies to method='exact' (the "
                f"embedded method {self.method!r} never evaluates Gram "
                f"blocks; its kernel is kernels/csrc/embed_assign.cu)")


class GlobalState(NamedTuple):
    """O(C·d) cross-batch state — the only thing that survives a batch."""
    medoids: torch.Tensor        # [C, d] medoid coordinates
    medoid_diag: torch.Tensor    # [C] K(m_j, m_j)
    cardinalities: torch.Tensor  # [C] accumulated |w_j| (f32)
    batches_done: int


class BatchStats(NamedTuple):
    inner_iters: int
    cost: float                  # Omega(W^i) at the inner fixpoint (Eq.9)
    displacement: np.ndarray     # [C] feature-space medoid displacement^2
    counts: np.ndarray           # [C] batch cluster cardinalities


class FitResult(NamedTuple):
    state: object                # GlobalState; EmbedState for the maps
    history: list
    fmap: object = None          # the feature map when method != "exact"
    spec: Optional[KernelSpec] = None

    def predict(self, x) -> torch.Tensor:
        """Label new rows on the device the fit ran on -> [n] int32, by
        nearest global medoid or, for an embedded fit, nearest centroid.
        Routed through the serving bucket ladder, as the reference's is:
        the result is frozen at f32 tiles whatever the fit's precision
        (``serving.freeze``) and labelled by ``serving.assign.predict``, so
        any row count runs on ``len(DEFAULT_BUCKETS)`` shapes. The freeze is
        per call (a count sketch's artifact takes the fit map's tables and
        gather programs); a long-lived service freezes once and holds an
        ``AssignService``."""
        if self.fmap is None and self.spec is None:
            raise ValueError(
                "FitResult.spec is not set: exact-path prediction needs the "
                "KernelSpec the model was fit with")
        from repro_torch.serving.artifact import freeze
        from repro_torch.serving.assign import predict as predict_frozen
        with span("obs:predict"):
            return predict_frozen(freeze(self), x)


def _generator(seq: np.random.SeedSequence) -> torch.Generator:
    hi, lo = seq.generate_state(2)
    return torch.Generator().manual_seed(int(hi) << 32 | int(lo))


def batch_generator(seed: int, i: int) -> torch.Generator:
    """The CPU generator of batch i: a function of (seed, i) alone."""
    return _generator(np.random.SeedSequence([seed, i]))


def map_generator(seed: int) -> torch.Generator:
    """The CPU generator of the feature map: a function of ``seed`` alone,
    distinct from every batch's (its spawn key sets it apart)."""
    return _generator(np.random.SeedSequence([seed], spawn_key=(1,)))


def draw_first(x: torch.Tensor, gen: torch.Generator, *,
               cfg: MiniBatchConfig, n_landmarks: int):
    """Batch 0's draws: (landmark indices, k-means++ seed indices)."""
    with span("obs:landmarks"):
        l_idx = select_landmark_indices(gen, x, n_landmarks, cfg.kernel,
                                        cfg.selector)
    seeds = kmeans_pp_indices(x, cfg.kernel.diag(x), gen,
                              n_clusters=cfg.n_clusters, spec=cfg.kernel)
    return l_idx, seeds


def draw_next(x: torch.Tensor, gen: torch.Generator, *,
              cfg: MiniBatchConfig, n_landmarks: int) -> torch.Tensor:
    """Batch i > 0's draw: landmark indices."""
    with span("obs:landmarks"):
        return select_landmark_indices(gen, x, n_landmarks, cfg.kernel,
                                       cfg.selector)


def _inner(x, l_idx, diag_k, labels0, cfg: MiniBatchConfig) -> InnerResult:
    return kkmeans_fit(x, l_idx, diag_k, labels0, spec=cfg.kernel,
                       n_clusters=cfg.n_clusters,
                       max_iters=cfg.max_inner_iters,
                       engine=resolve_engine(cfg.engine, cfg.precision))


def _first_batch_step(x: torch.Tensor, l_idx: torch.Tensor,
                      seeds: torch.Tensor, *, cfg: MiniBatchConfig):
    """Batch 0: init from the seeds, inner loop, medoid extraction."""
    spec = cfg.kernel
    diag_k = spec.diag(x)
    seed_x = x[seeds]
    labels0, _ = assign_to_medoids(x, diag_k, seed_x, spec.diag(seed_x),
                                   spec=spec)
    res = _inner(x, l_idx, diag_k, labels0, cfg)
    with span("obs:merge"):
        m_idx = medoid_indices(
            diag_k, res.f, res.labels, res.counts,
            restrict_to_members=cfg.restrict_medoids_to_members)
        medoids = x[m_idx]
        state = GlobalState(medoids=medoids, medoid_diag=spec.diag(medoids),
                            cardinalities=res.counts, batches_done=1)
    return state, res


def _next_batch_step(x: torch.Tensor, l_idx: torch.Tensor,
                     state: GlobalState, *, cfg: MiniBatchConfig):
    """Batch i > 0: Eq.8 init, inner loop, Eq.7 medoids, Eq.12 merge."""
    spec = cfg.kernel
    diag_k = spec.diag(x)
    labels0, k_tilde = assign_to_medoids(x, diag_k, state.medoids,
                                         state.medoid_diag, spec=spec)
    res = _inner(x, l_idx, diag_k, labels0, cfg)
    with span("obs:merge"):
        m_idx = medoid_indices(
            diag_k, res.f, res.labels, res.counts,
            restrict_to_members=cfg.restrict_medoids_to_members)
        k_xm = spec(x, x[m_idx]).to(torch.float32)                 # [n, C]

        # merge (Eq.11-13): minimize over the batch
        #   K_ll - 2(1-a) K(x_l, m_j) - 2a K(x_l, m_j^i) + const(j)
        alpha = res.counts / torch.clamp(res.counts + state.cardinalities,
                                         min=1.0)
        score = (diag_k.to(torch.float32)[:, None]
                 - 2.0 * (1.0 - alpha)[None, :] * k_tilde
                 - 2.0 * alpha[None, :] * k_xm)
        merged = x[torch.argmin(score, dim=0)]

        # empty batch cluster -> alpha = 0 -> keep the old global medoid
        keep = res.counts == 0
        new_medoids = torch.where(keep[:, None], state.medoids, merged)
        new_diag = torch.where(keep, state.medoid_diag, spec.diag(merged))

        # displacement diagnostic (Fig.4b): ||phi(m_new) - phi(m_old)||^2
        cross = spec.paired(new_medoids, state.medoids)
        disp = torch.clamp(new_diag + state.medoid_diag - 2.0 * cross,
                           min=0.0)

        new_state = GlobalState(
            medoids=new_medoids, medoid_diag=new_diag,
            cardinalities=state.cardinalities + res.counts,
            batches_done=state.batches_done + 1)
    return new_state, res, disp


def batch_stats(res, disp: Optional[torch.Tensor]) -> BatchStats:
    """A batch's ``BatchStats`` read to the host from its inner result
    (``n_iter``, ``cost``, ``counts``) and its displacement (``None`` for
    batch 0: zeros, never on the device). Each read of a device value sits
    in its own ``obs:host_read[batch_stats]`` span."""
    with span("obs:host_read[batch_stats]"):
        cost = float(res.cost)
    if disp is None:
        disp = np.zeros(res.counts.shape[0], dtype=np.float32)
    else:
        with span("obs:host_read[batch_stats]"):
            disp = disp.cpu().numpy()
    with span("obs:host_read[batch_stats]"):
        counts = res.counts.cpu().numpy()
    return BatchStats(inner_iters=res.n_iter, cost=cost, displacement=disp,
                      counts=counts)


def predict(x, medoids: torch.Tensor, medoid_diag: torch.Tensor, *,
            spec: KernelSpec, device=None) -> torch.Tensor:
    """Label rows by nearest global medoid in feature space -> [n] int32."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    labels, _ = assign_to_medoids(x, spec.diag(x), medoids.to(dev),
                                  medoid_diag.to(dev), spec=spec)
    return labels


def fit(batches: Iterable, cfg: MiniBatchConfig, *,
        state: Optional[GlobalState] = None,
        checkpoint_cb: Optional[Callable[[GlobalState, int], None]] = None,
        fmap=None, device=None, recorder=None) -> FitResult:
    """Run the outer loop over an iterable of mini-batches (numpy arrays,
    tensors or, for the sketch methods, CSR batches) or a ``BatchSource``,
    which is closed on exit. A tensor already on the device in f32 is used
    as it is. Passing a previous ``state`` resumes after a restart: the
    iterable then yields only the remaining batches (``BatchSource.skip``).
    ``checkpoint_cb(state, i)`` is called after every merged batch. An
    embedded fit (``cfg.method != "exact"``) resumes only with its original
    ``fmap``. ``recorder`` is a ``repro_torch.obs`` flight recorder (see
    the module docstring). The fit runs in one ``obs:fit`` span."""
    with span("obs:fit"):
        return _fit(batches, cfg, state=state, checkpoint_cb=checkpoint_cb,
                    fmap=fmap, device=device, recorder=recorder)


def _fit(batches, cfg: MiniBatchConfig, *, state=None, checkpoint_cb=None,
         fmap=None, device=None, recorder=None) -> FitResult:
    rec = resolve_recorder(recorder)
    with closing_source(batches):
        if cfg.method != "exact":
            return _fit_embedded(batches, cfg, state=state,
                                 checkpoint_cb=checkpoint_cb, fmap=fmap,
                                 device=device, recorder=rec)
        return _fit_exact(batches, cfg, state=state,
                          checkpoint_cb=checkpoint_cb, device=device,
                          rec=rec)


def _fit_exact(batches, cfg: MiniBatchConfig, *, state, checkpoint_cb,
               device, rec) -> FitResult:
    dev = resolve_device(device)
    if state is not None:
        state = GlobalState(state.medoids.to(dev), state.medoid_diag.to(dev),
                            state.cardinalities.to(dev), state.batches_done)
    history: list[BatchStats] = []
    start = state.batches_done if state is not None else 0
    for i, xb in batch_spans(batches, start):
        t_batch = time.perf_counter()
        if is_sparse(xb):
            raise ValueError(
                "method='exact' evaluates kernel blocks on dense rows and "
                "cannot take CSRBatch mini-batches; use a sketch method "
                "(method='sketch'|'tensorsketch') to stay O(nnz), or "
                "densify explicitly with repro_torch.data.sparse.to_dense")
        with span("obs:stage"):
            xb = to_device(xb, dev)
        n_l = num_landmarks(xb.shape[0], cfg.s, n_clusters=cfg.n_clusters,
                            multiple_of=cfg.landmark_multiple_of)
        gen = batch_generator(cfg.seed, i)
        if state is None:
            l_idx, seeds = draw_first(xb, gen, cfg=cfg, n_landmarks=n_l)
            state, res = _first_batch_step(xb, l_idx, seeds, cfg=cfg)
            disp = None
        else:
            l_idx = draw_next(xb, gen, cfg=cfg, n_landmarks=n_l)
            state, res, disp = _next_batch_step(xb, l_idx, state, cfg=cfg)
        # the cost tensor waits for the boundary's one read
        rec.series("inner/cost", res.cost, batch=i)
        rec.series("inner/iters", res.n_iter, batch=i)
        history.append(batch_stats(res, disp))
        if checkpoint_cb is not None:
            checkpoint_cb(state, i)
        if rec.enabled:
            h = history[-1]
            n = xb.shape[0]
            rec.series("batch/wall_seconds", time.perf_counter() - t_batch,
                       batch=i, rows=n)
            rec.gauge("clusters/empty", int((h.counts == 0).sum()), batch=i)
            rec.gauge("medoids/mean_displacement",
                      float(np.mean(h.displacement)), batch=i)
            obs_memory.watermark(
                rec, batch=i, device=dev,
                engine=resolve_engine(cfg.engine, cfg.precision).mode,
                predicted_bytes=obs_memory.predicted_batch_footprint(
                    cfg, n, int(xb.shape[1])))
            rec.batch_boundary(i)
    if state is None:
        raise ValueError("empty batch iterable")
    return FitResult(state, history, spec=cfg.kernel)


def _fit_embedded(batches, cfg: MiniBatchConfig, *, state, checkpoint_cb,
                  fmap, device, recorder) -> FitResult:
    """The embedded-space target of ``fit``: draw the map from the first
    batch (unless one is given), then the embedded outer loop."""
    from repro_torch import approx

    it = iter(batches)
    if fmap is None:
        if state is not None:
            raise ValueError(
                "resuming an embedded fit requires the original fmap "
                "(the sampled feature map is part of the model)")
        with span("obs:stage"):
            try:
                first = next(it)
            except StopIteration:
                raise ValueError("empty batch iterable") from None
            first = to_device(first, resolve_device(device))
        m = cfg.embed_dim or approx.default_embed_dim(cfg.n_clusters)
        with span("obs:embed_phi"):
            fmap = approx.make_feature_map(
                cfg.method, map_generator(cfg.seed), first, m, cfg.kernel,
                orthogonal=cfg.rff_orthogonal, selector=cfg.selector)
        it = itertools.chain([first], it)
    est, history = approx.fit_embedded(
        it, fmap, n_clusters=cfg.n_clusters, max_iters=cfg.max_inner_iters,
        seed=cfg.seed, state=state, checkpoint_cb=checkpoint_cb,
        recorder=recorder, precision=cfg.precision, device=device)
    return FitResult(est, history, fmap=fmap, spec=cfg.kernel)


def fit_dataset(x, cfg: MiniBatchConfig, *, device=None, **kw) -> FitResult:
    """Stride/block-split a resident dataset (dense [n, d] or a CSR batch)
    into a ``BatchSource`` of B batches, then ``fit``; the split lies in
    the fit's ``obs:fit`` span."""
    dev = resolve_device(device)
    with span("obs:fit"):
        return _fit(BatchSource.from_dataset(x, cfg.n_batches,
                                             strategy=cfg.sampling,
                                             device=dev),
                    cfg, device=dev, **kw)
