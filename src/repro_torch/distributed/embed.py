"""Distributed embedded-space (RFF / Nystrom / sketch) mini-batch k-means,
the port of ``repro/distributed/embed.py``.

With an explicit map the heavy step is embarrassingly parallel: each rank
embeds only its own rows, z = phi_m(x_local), and a Lloyd sweep needs ONE
collective, an all_reduce of the per-cluster partial sums and counts with
the changed count and the cost appended, C*(m+1) + 2 values, summed in
f64 so the state does not depend on the world size. Alg.1's inner
loop gathers the N/(B*P) labels AND reduces g every iteration; this path
moves O(C*m) whatever the batch size.

Ingestion is staged: ``stage`` turns a raw host batch (dense [n, d] rows
or a CSR batch) into a ``StagedBatch``, this rank's row block on the
device with its weights (0 on the ghost rows that pad the batch to the
mesh rows, so they never bias a mean). A CSR batch is padded with its
ghost rows and cut into equal-shape shards (``data.sparse.shard_csr`` with
a quantized stored-slot capacity, so a ragged stream maps to a few
shapes; ``shard_row_mask`` gives the weights), and each rank embeds its
own shard with the O(nnz) sketch: the [rows, m] embedding is the only
dense array built from sparse input. ``source`` wraps a batch iterable in
a ``BatchSource`` that stages on a producer thread (§3.3).

The host loop mirrors ``approx.embed_kmeans.fit_embedded``: O(C*m) state
across batches, the exact Eq.12-style merge. Batch 0's k-means++ seeds are
drawn over the unpadded embedded rows of the whole batch (one all_gather
of the [rows, m] blocks, first batch only), with the single-host draw
``approx.embed_kmeans.draw_first``, so a mesh fit seeds as the single-host
fit does.

``recorder=`` (``repro_torch.obs``) gets the reference's records: the
``stage/seconds`` timer of every staged batch (from the producer thread
under ``source``, which is why the recorder takes a lock) and, per batch,
the ``collectives/psum`` and ``collectives/psum_bytes`` counters of the
Lloyd loop (measured by ``mesh.tally()`` around it: the sweeps and the
prologue, not batch 0's seeding gather; see ``distributed/outer.py`` on
why there is no static audit), the wall seconds, the cost and iterations
and an allocator watermark.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional

import torch

from repro_torch.analysis.dispatch import iteration, loop
from repro_torch.approx.embed_kmeans import (EmbedState, assign_embedded,
                                             draw_first)
from repro_torch.core.minibatch import (BatchStats, FitResult,
                                        MiniBatchConfig, batch_generator,
                                        map_generator)
from repro_torch.data.loader import BatchSource, closing_source
from repro_torch.data.sparse import (CSRBatch, as_csr, concat_csr, is_sparse,
                                     shard_csr, shard_row_mask, stored,
                                     take_rows)
from repro_torch.kernels.precision import resolve_precision
from repro_torch.obs import memory as obs_memory
from repro_torch.obs import resolve as resolve_recorder
from repro_torch.obs.trace import span

from .mesh import (all_gather, all_reduce, axis_rank, axis_size,
                   ghost_row_ids, mesh_device, row_axes_of, tally)


@dataclasses.dataclass(frozen=True)
class StagedBatch:
    """A mini-batch staged on the mesh: this rank's row block on the device.

    Dense: ``x`` [rows, d]. CSR: ``csr``, this rank's equal-shape shard
    (rows rows, one stored-slot capacity). ``wgt`` [rows] is 0 on ghost
    rows; ``n`` the logical (unpadded) row count; ``host`` the raw batch,
    which a data-dependent map (Nystrom) samples."""

    wgt: torch.Tensor
    n: int
    rows: int                 # rows per shard
    d: int
    x: Optional[torch.Tensor] = None
    csr: Optional[CSRBatch] = None
    host: object = None

    @property
    def sparse(self) -> bool:
        return self.x is None

    def __len__(self) -> int:
        return self.n


def collectives_per_iteration(n_clusters: int, m: int) -> dict:
    """The analytic per-Lloyd-sweep bill of the shard loop: ONE all_reduce
    ("psum", the reference's name) of sums + counts + changed + cost,
    C*(m+1) + 2 f64 values; the prologue sync before the loop is the same
    payload (``final_psum``, the reference's name for that slot)."""
    payload = 8 * (n_clusters * (m + 1) + 2)
    return {"psum": 1, "psum_bytes": payload,
            "final_psum": 1, "final_psum_bytes": payload}


class DistributedEmbedKMeans:
    """Mesh-resident embedded-space mini-batch k-means. ``fmap`` may be
    passed already drawn (resume, or a map shared with another fit); else
    it is drawn from the first batch per ``cfg.method`` / ``cfg.embed_dim``
    with ``core.minibatch.map_generator(cfg.seed)``, as the single-host fit
    draws it."""

    def __init__(self, mesh, cfg: MiniBatchConfig, *, fmap=None,
                 recorder=None):
        if cfg.method == "exact":
            raise ValueError("DistributedEmbedKMeans needs an embedded "
                             "cfg.method ('rff', 'nystrom', 'sketch', "
                             "'tensorsketch'); use "
                             "DistributedMiniBatchKMeans for 'exact'")
        self.mesh = mesh
        self.cfg = cfg
        self.fmap = fmap
        self.rec = resolve_recorder(recorder)
        self.device = mesh_device(mesh)
        self.row_axes = row_axes_of(mesh)
        self.d_size = axis_size(mesh, self.row_axes)
        self.rank = axis_rank(mesh, self.row_axes)

    # -- the feature map ---------------------------------------------------

    def _ensure_fmap(self, sample):
        """Draw the map from the first batch (raw or staged). Nystrom with
        ``selector="rls"`` on a dense batch takes the mesh route
        (``_make_nystrom_rls``); the other maps see the unpadded batch as
        the single-host fit does (the sketches read only its width)."""
        if self.fmap is not None:
            return self.fmap
        from repro_torch import approx
        from repro_torch.approx.selectors import name_of
        cfg = self.cfg
        m = cfg.embed_dim or approx.default_embed_dim(cfg.n_clusters)
        st = self.stage(sample)
        host = st.host
        if (cfg.method == "nystrom" and name_of(cfg.selector) == "rls"
                and not st.sparse):
            self.fmap = self._make_nystrom_rls(st, m)
            return self.fmap
        if is_sparse(host):
            d = as_csr(host).shape[1]
            host = CSRBatch(torch.zeros(0), torch.zeros(0, dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int64), (0, d))
            host = host.to(self.device)
        else:
            host = torch.as_tensor(host, dtype=torch.float32).to(self.device)
        self.fmap = approx.make_feature_map(
            cfg.method, map_generator(cfg.seed), host, m, cfg.kernel,
            orthogonal=cfg.rff_orthogonal, selector=cfg.selector)
        return self.fmap

    def _make_nystrom_rls(self, st: StagedBatch, m: int):
        """Ridge-leverage-score Nystrom from a staged batch: the single-host
        ``RLSSelector``'s draws (keyed per global row id from the map
        generator's key), but the [m, m] leverage sketch G = C^T diag(wgt)
        C is summed from the ranks' partials with ONE all_reduce and each
        rank scores its own rows; one all_gather brings the scores
        together for the keyed draw."""
        from repro_torch.approx import nystrom_from_landmarks, selectors
        cfg, spec = self.cfg, self.cfg.kernel
        sel = selectors.resolve(cfg.selector)
        host = torch.as_tensor(st.host, dtype=torch.float32)
        n = st.n
        if m == n:
            return nystrom_from_landmarks(host.to(self.device), spec,
                                          eps=sel.eps)
        key = selectors.key_from(map_generator(cfg.seed))
        gids = torch.arange(n)
        pidx = sel.pilot_indices(
            selectors.keyed_uniform(key, selectors._TAG_PILOT, gids), m)
        pilot = host[pidx].to(self.device)
        whiten = selectors.pilot_whitening(pilot, spec, eps=sel.eps)
        c = spec(st.x, pilot).to(torch.float32) @ whiten          # [rows, m]
        g = all_reduce(c.T @ (c * st.wgt[:, None]), self.mesh,
                       self.row_axes)                             # [m, m]
        scores = selectors.rls_scores(c, spec.diag(st.x), g,
                                      delta=sel.delta)
        scores = torch.where(st.wgt > 0, scores, torch.zeros_like(scores))
        scores = all_gather(scores, self.mesh, self.row_axes)[:n].cpu()
        idx = sel.gumbel_top_m(
            scores, selectors.keyed_gumbel(key, selectors._TAG_SELECT, gids),
            m)
        return nystrom_from_landmarks(host[idx].to(self.device), spec,
                                      eps=sel.eps)

    # -- staging: host batch -> this rank's block on the device ------------

    def stage(self, xb) -> StagedBatch:
        """Pad, shard and copy one raw batch (dense or CSR) to the device.
        Runs on the host: a producer thread through ``source``, or inline
        in ``fit``."""
        if isinstance(xb, StagedBatch):
            return xb
        with self.rec.timer("stage/seconds"), span("obs:stage"):
            if is_sparse(xb):
                return self._stage_csr(as_csr(xb).to("cpu"))
            return self._stage_dense(torch.as_tensor(xb, dtype=torch.float32)
                                     .cpu())

    def _wgt(self, n: int) -> torch.Tensor:
        """This rank's row weights: 1 on real rows, 0 on ghost rows."""
        return shard_row_mask(n, self.d_size)[self.rank].to(
            torch.float32).to(self.device)

    def _stage_dense(self, xb: torch.Tensor) -> StagedBatch:
        n = len(xb)
        idx = torch.from_numpy(ghost_row_ids(n, self.d_size))
        rows = (n + len(idx)) // self.d_size
        a, z = self.rank * rows, (self.rank + 1) * rows
        # this rank's block of [batch ++ ghost rows]: replicated head rows
        # so ghosts are real points, weight-masked out of the means
        block = xb[a:min(z, n)]
        if z > n:
            block = torch.cat([block, xb[idx[max(a - n, 0):z - n]]])
        return StagedBatch(wgt=self._wgt(n), n=n, rows=rows, d=xb.shape[1],
                           x=block.to(self.device), host=xb)

    def _stage_csr(self, xb: CSRBatch) -> StagedBatch:
        n, d = xb.shape
        idx = ghost_row_ids(n, self.d_size)
        padded = concat_csr([xb, take_rows(xb, idx)]) if len(idx) else xb
        rows = len(padded) // self.d_size
        # the stored-slot capacity quantized (geometric, at most ~12.5%
        # slack), so a long stream of ragged batches maps to a few shapes
        est = max(256, stored(xb) // self.d_size)
        quantum = max(256, 1 << max(0, est.bit_length() - 3))
        shard = shard_csr(padded, self.d_size,
                          nnz_multiple=quantum)[self.rank]
        return StagedBatch(wgt=self._wgt(n), n=n, rows=rows, d=d,
                           csr=shard.to(self.device), host=xb)

    def source(self, batches: Iterable, *, depth: int = 2,
               skip: int = 0) -> BatchSource:
        """Wrap raw batches in a ``BatchSource`` whose producer thread
        stages each one onto this mesh (§3.3)."""
        return BatchSource(batches, stage=self.stage, prefetch=depth,
                           skip=skip, recorder=self.rec)

    # -- the shard-local steps ---------------------------------------------

    def _embed(self, st: StagedBatch) -> torch.Tensor:
        """z = phi_m(rows) of this rank's block, CSR shards by the O(nnz)
        sketch, rounded once to the tile dtype."""
        prec = resolve_precision(self.cfg.precision)
        with span("obs:embed_phi"):
            z = self.fmap(st.csr if st.sparse else st.x)
        return prec.cast_tiles(z.to(torch.float32))

    def _sync(self, z, wgt, labels, changed_f, cost_loc):
        """ONE all_reduce of sums [C, m], counts [C], changed and cost ->
        (centroids, counts, changed, cost). The sums of the f32 rows are
        taken and reduced in f64, where they are exact but for a few
        rounding-boundary cases, and the means rounded once to f32: so the
        state does not depend on how many ranks split the rows, and a fit
        resumed on another world size is bitwise the uninterrupted one."""
        c, m = self.cfg.n_clusters, z.shape[1]
        with span("obs:psum_fused"):
            h = torch.nn.functional.one_hot(labels.long(), c).to(
                torch.float64)
            h = h * wgt.to(torch.float64)[:, None]    # ghost rows -> 0
            sums = h.T @ z.to(torch.float64)
            flat = all_reduce(torch.cat([
                sums.reshape(-1), torch.sum(h, dim=0),
                torch.stack([changed_f, cost_loc]).to(torch.float64)]),
                self.mesh, self.row_axes)             # [C*(m+1) + 2]
        counts = flat[c * m:-2]
        cents = flat[:c * m].reshape(c, m) / torch.clamp(counts, min=1.0)[
            :, None]
        return (cents.to(torch.float32), counts.to(torch.float32),
                flat[-2], flat[-1].to(torch.float32))

    def _shard_lloyd(self, z, wgt, labels0):
        """Lloyd on this rank's rows: the pipelined body of the reference
        (assign from the carried stats, then sync the stats of the labels
        just written), ONE all_reduce a sweep plus the prologue's, and one
        host read of the changed count a sweep. Changes are weighted, so
        ghost rows (which move no mean) never keep the loop going.
        -> (labels, centroids, counts, n_iter, cost)."""
        dev = z.device
        zero = torch.zeros((), device=dev)
        cents, counts, _, _ = self._sync(z, wgt, labels0, zero, zero)
        labels, t, changed = labels0, 0, True
        cost = torch.tensor(float("inf"), device=dev)
        with loop("embed_lloyd"):
            while changed and t < self.cfg.max_inner_iters:
                iteration()
                new, mind = assign_embedded(z, cents, counts)
                changed_f = torch.sum((new != labels).to(torch.float32)
                                      * wgt)
                cents, counts, changed_t, cost = self._sync(
                    z, wgt, new, changed_f, torch.sum(mind * wgt))
                labels, t = new, t + 1
                changed = float(changed_t) > 0          # the one host read
        return labels, cents, counts, t, cost

    # -- the fit loop -------------------------------------------------------

    def fit(self, batches: Iterable, *, state: Optional[EmbedState] = None,
            checkpoint_cb=None) -> FitResult:
        """Run the outer loop over raw batches (dense rows or CSR, staged
        inline; every rank the same) or staged ones (``source``). A
        closable source is closed on exit, success or failure."""
        with closing_source(batches):
            return self._fit(batches, state=state,
                             checkpoint_cb=checkpoint_cb)

    def _fit(self, batches, *, state, checkpoint_cb) -> FitResult:
        cfg, dev = self.cfg, self.device
        c = cfg.n_clusters
        if state is not None:
            if self.fmap is None:
                raise ValueError("resuming requires the original fmap")
            state = EmbedState(state.centroids.to(dev),
                               state.cardinalities.to(dev),
                               int(state.batches_done))
        rec = self.rec
        history: list[BatchStats] = []
        start = state.batches_done if state is not None else 0
        for i, xb in enumerate(batches, start=start):
            t_batch = time.perf_counter()
            st = self.stage(xb)
            self._ensure_fmap(st)
            z = self._embed(st)
            if state is None:
                # the whole batch's unpadded embedded rows, seeded as the
                # single-host fit seeds them
                zn = all_gather(z.to(torch.float32), self.mesh,
                                self.row_axes)[:st.n].to(z.dtype)
                seeds = draw_first(zn, batch_generator(cfg.seed, i),
                                   n_clusters=c)
                labels0, _ = assign_embedded(z, zn[seeds])
                cards = torch.zeros(c, device=dev)
            else:
                labels0, _ = assign_embedded(z, state.centroids,
                                             state.cardinalities)
                cards = state.cardinalities
            with tally() as bill:
                _, cents, counts, t, cost = self._shard_lloyd(z, st.wgt,
                                                              labels0)
            if state is None:
                new_centroids, done = cents, 1
                disp = torch.zeros(c)
            else:
                alpha = counts / torch.clamp(counts + cards, min=1.0)
                merged = ((1.0 - alpha)[:, None] * state.centroids
                          + alpha[:, None] * cents)
                keep = (counts == 0)[:, None]
                new_centroids = torch.where(keep, state.centroids, merged)
                disp = torch.sum((new_centroids - state.centroids) ** 2,
                                 dim=1)
                done = state.batches_done + 1
            state = EmbedState(new_centroids, cards + counts, done)
            history.append(BatchStats(
                inner_iters=t, cost=float(cost),
                displacement=disp.cpu().numpy(),
                counts=counts.cpu().numpy()))
            if checkpoint_cb is not None:
                checkpoint_cb(state, i)
            if rec.enabled:
                rec.counter("collectives/psum", bill.psum, batch=i)
                rec.counter("collectives/psum_bytes", bill.psum_bytes,
                            batch=i)
                rec.series("batch/wall_seconds",
                           time.perf_counter() - t_batch, batch=i, rows=st.n)
                rec.series("inner/cost", history[-1].cost, batch=i)
                rec.series("inner/iters", t, batch=i)
                density = (stored(as_csr(st.host)) / max(st.n * st.d, 1)
                           if st.sparse else 1.0)
                obs_memory.watermark(
                    rec, batch=i, device=dev, predicted_bytes=(
                        obs_memory.predicted_embed_footprint(
                            st.n, c, self.fmap, sparse=st.sparse,
                            density=density, n_devices=self.d_size)))
                rec.batch_boundary(i)
        if state is None:
            raise ValueError("empty batch iterable")
        return FitResult(state, history, fmap=self.fmap, spec=cfg.kernel)
