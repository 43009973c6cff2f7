"""Distributed mini-batch outer loop (Alg.1 end to end on a mesh), the
port of ``repro/distributed/outer.py``.

The host orchestration of ``core/minibatch.py``, with every O(N/B) step
on the rank's row block:

  * Eq.8 init + K~^i      -> the row block against the C global medoids
  * inner loop            -> ``distributed.inner`` (Alg.1 lines 9-16)
  * Eq.7 medoids          -> a local argmin, then one all_gather of
                             (value, global index) and the lowest-index
                             minimum (line 18, "allreduce min M^i")
  * Eq.12 merge           -> the row block's score, the same argmin (line
                             20, "allreduce min M")

Every rank is handed the whole mini-batch on the host (as the reference's
single controller sees the global array), draws the same landmarks from
``core.minibatch.batch_generator(seed, i)`` and copies only its row block
to the device; landmark and medoid rows are taken from the host batch.
Only O(C*d) state crosses batches, so it does not depend on the mesh:
checkpoints restore on another world size (``ft/``).

A batch that does not divide the mesh rows is padded with modulo-
replicated ghost rows, weight-masked: they are never landmark candidates
(selection runs over the unpadded rows with ``cfg.selector``), never win a
medoid or merge argmin and never count in the cost, so a P∤(N/B) fit
gives the single-host cardinalities and Eq.12 alphas exactly.

``recorder=`` (``repro_torch.obs``) gets the reference's per-batch
records: the ``collectives/psum``, ``collectives/allgather`` and
``collectives/psum_bytes`` counters of the inner fit, the wall seconds,
the inner cost and iterations, an allocator watermark and a
``StragglerMonitor`` timing (this rank's). The collective bill is
MEASURED: ``mesh.tally()`` counts the calls and bytes that pass through
``mesh.all_gather`` / ``all_reduce`` while the inner fit runs, which
leaves out the Eq.7 / Eq.12 argmin gathers, as the reference's bill does.
The reference bills from a static audit of the traced program and falls
back to the analytic bill with an ``audit_error`` event when tracing
fails; the port has no traced program to audit and nothing that can fail
to trace, so it has no ``audit_error``. ``inner.
collectives_per_iteration`` stays the analytic bill the tally must meet:
per sync x (iterations + 1, the prologue).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.approx.selectors import name_of
from repro_torch.core.engine import resolve_engine
from repro_torch.core.init import assign_to_medoids, kmeans_pp_indices
from repro_torch.core.landmarks import (choose_landmarks, num_landmarks,
                                        select_landmark_indices)
from repro_torch.core.minibatch import (BatchStats, FitResult, GlobalState,
                                        MiniBatchConfig, batch_generator,
                                        batch_stats)
from repro_torch.data.loader import closing_source
from repro_torch.data.sparse import is_sparse
from repro_torch.kernels.ops import BIG
from repro_torch.obs import batch_spans, span
from repro_torch.obs import memory as obs_memory
from repro_torch.obs import resolve as resolve_recorder

from .inner import DistributedInnerConfig, _inner_local, split_rows
from .mesh import (all_gather, axis_rank, axis_size, ghost_row_ids,
                   mesh_device, row_axes_of, tally)


def _dist_argmin_rows(mesh, row_axes, score_local: torch.Tensor):
    """argmin over the row-split axis 0 of ``score`` [n, C] -> [C] global
    row indices (int64): the local argmin, then ONE all_gather of (value
    bits, global index) and the minimum, lowest index on ties (shards are
    contiguous and in row order)."""
    rows = score_local.shape[0]
    val, idx = torch.min(score_local, dim=0)           # lowest local index
    gidx = axis_rank(mesh, row_axes) * rows + idx
    packed = torch.stack([val.to(torch.float32).view(torch.int32),
                          gidx.to(torch.int32)])[None]          # [1, 2, C]
    got = all_gather(packed, mesh, row_axes)                    # [D, 2, C]
    vals = got[:, 0].contiguous().view(torch.float32)
    best = torch.argmin(vals, dim=0)
    return got[:, 1].gather(0, best[None])[0].long()


class DistributedMiniBatchKMeans:
    """Mesh-resident mini-batch kernel k-means (the production entry
    point). Runs on the mesh's device: ``cuda`` over NCCL, ``cpu`` over
    gloo."""

    def __init__(self, mesh, cfg: MiniBatchConfig, *, mode: object = None,
                 recorder=None):
        """``mode`` names the GramEngine of the inner loop ("materialize" |
        "fused" | "tiled" or a ``core.engine.GramEngine``); default
        ``cfg.engine``. ``recorder`` is a ``repro_torch.obs`` flight
        recorder (see the module docstring)."""
        if cfg.method != "exact":
            raise ValueError("DistributedMiniBatchKMeans runs method="
                             "'exact'; use DistributedEmbedKMeans for "
                             f"{cfg.method!r}")
        self.mesh = mesh
        self.cfg = cfg
        self.rec = resolve_recorder(recorder)
        self.device = mesh_device(mesh)
        self.row_axes = row_axes_of(mesh)
        self.col_axis = "model" if "model" in mesh.mesh_dim_names else None
        self.d_size = axis_size(mesh, self.row_axes)
        self.m_size = axis_size(mesh, self.col_axis) if self.col_axis else 1
        self.inner_cfg = DistributedInnerConfig(
            n_clusters=cfg.n_clusters, kernel=cfg.kernel,
            max_iters=cfg.max_inner_iters,
            engine=resolve_engine(cfg.engine if mode is None else mode),
            precision=cfg.precision, row_axes=self.row_axes,
            col_axis=self.col_axis, s_step=cfg.s_step)
        # the watermark prices the residency the inner loop runs (``mode``
        # may override cfg.engine; the reference prices cfg.engine's)
        self._priced_cfg = dataclasses.replace(cfg,
                                               engine=self.inner_cfg.engine)

    # -- helpers -----------------------------------------------------------

    def _landmark_count(self, n: int) -> int:
        return num_landmarks(
            n, self.cfg.s, n_clusters=self.cfg.n_clusters,
            multiple_of=int(np.lcm(self.d_size, self.m_size)))

    def _choose_landmarks(self, gen, xb: torch.Tensor, n_pad: int):
        """(l_idx, |L|) for one batch of ``len(xb)`` real rows padded by
        ``n_pad`` ghost rows, selected over the UNPADDED rows; only a tail
        batch smaller than the landmark alignment falls back to the padded
        row space (<= P-1 duplicated landmarks, the reference's documented
        residual bias)."""
        n = len(xb)
        mult = int(np.lcm(self.d_size, self.m_size))
        if n >= mult:
            n_l = self._landmark_count(n)
            # uniform reads only the row count; the others score the rows
            sample = (xb if name_of(self.cfg.selector) == "uniform"
                      else xb.to(self.device))
            l_idx = select_landmark_indices(gen, sample, n_l,
                                            self.cfg.kernel,
                                            self.cfg.selector)
        else:
            n_l = self._landmark_count(n + n_pad)
            l_idx = choose_landmarks(gen, n + n_pad, n_l)
        return l_idx.cpu(), n_l

    def _medoid_merge(self, xb: torch.Tensor, x: torch.Tensor,
                      diag: torch.Tensor, res, k_tilde: torch.Tensor,
                      state: GlobalState, first: bool, wgt: torch.Tensor):
        """Eq.7 batch medoids + Eq.12 merge through the distributed argmin;
        ``wgt`` (0 on ghost rows) keeps the chosen row indices those of the
        single-host run. ``xb`` is the padded host batch, x this rank's
        block of it on the device."""
        spec, dev = self.cfg.kernel, self.device
        ghost = (1.0 - wgt)[:, None] * BIG
        score7 = diag.to(torch.float32)[:, None] - 2.0 * res.f + ghost
        m_idx = _dist_argmin_rows(self.mesh, self.row_axes, score7)
        with span("obs:host_read[merge_rows]"):
            m_idx = m_idx.cpu()
        batch_medoids = xb[m_idx].to(dev)
        if first:
            medoids = batch_medoids
            mdiag = spec.diag(batch_medoids)
            cards = res.counts
            disp = None
        else:
            alpha = res.counts / torch.clamp(
                res.counts + state.cardinalities, min=1.0)
            kxm = spec(x, batch_medoids).to(torch.float32)
            score12 = (diag.to(torch.float32)[:, None]
                       - 2.0 * (1.0 - alpha)[None, :] * k_tilde
                       - 2.0 * alpha[None, :] * kxm) + ghost
            merge_idx = _dist_argmin_rows(self.mesh, self.row_axes, score12)
            with span("obs:host_read[merge_rows]"):
                merge_idx = merge_idx.cpu()
            merged = xb[merge_idx].to(dev)
            keep = res.counts == 0
            medoids = torch.where(keep[:, None], state.medoids, merged)
            mdiag = torch.where(keep, state.medoid_diag, spec.diag(merged))
            cross = spec.paired(medoids, state.medoids)
            disp = torch.clamp(mdiag + state.medoid_diag - 2.0 * cross,
                               min=0.0)
            cards = state.cardinalities + res.counts
        new_state = GlobalState(
            medoids=medoids, medoid_diag=mdiag, cardinalities=cards,
            batches_done=state.batches_done + 1 if not first else 1)
        return new_state, disp

    # -- the fit loop -------------------------------------------------------

    def fit(self, batches: Iterable, *, state: Optional[GlobalState] = None,
            checkpoint_cb=None) -> FitResult:
        """Run the outer loop over whole host mini-batches (numpy arrays or
        tensors; every rank the same) or a ``BatchSource`` (closed on
        exit). ``state`` resumes: the iterable then yields the remaining
        batches. ``checkpoint_cb(state, i)`` runs after every merge. The
        fit runs in one ``obs:fit`` span."""
        with span("obs:fit"), closing_source(batches):
            return self._fit(batches, state=state,
                             checkpoint_cb=checkpoint_cb)

    def _fit(self, batches, *, state, checkpoint_cb) -> FitResult:
        cfg, dev = self.cfg, self.device
        spec = cfg.kernel
        if state is not None:
            state = GlobalState(state.medoids.to(dev),
                                state.medoid_diag.to(dev),
                                state.cardinalities.to(dev),
                                int(state.batches_done))
        rec = self.rec
        monitor = None
        if rec.enabled:
            from repro_torch.ft.straggler import StragglerMonitor
            monitor = StragglerMonitor(rec)
        history: list[BatchStats] = []
        start = state.batches_done if state is not None else 0
        for i, xb in batch_spans(batches, start):
            t_batch = time.perf_counter()
            if is_sparse(xb):
                raise ValueError(
                    "method='exact' evaluates kernel blocks on dense rows "
                    "and cannot take CSRBatch mini-batches; use "
                    "DistributedEmbedKMeans with a sketch method")
            with span("obs:stage"):
                xb = torch.as_tensor(xb, dtype=torch.float32).cpu()
            n = len(xb)
            idx = ghost_row_ids(n, self.d_size)
            # batch i's draws depend on (seed, i) alone, so a resumed fit
            # replays the uninterrupted run's landmarks
            gen = batch_generator(cfg.seed, i)
            with span("obs:landmarks"):
                l_idx, _ = self._choose_landmarks(gen, xb, len(idx))
            with span("obs:stage"):
                if len(idx):
                    xb = torch.cat([xb, xb[torch.from_numpy(idx)]])
                wgt_all = torch.ones(len(xb))
                wgt_all[n:] = 0.0
                blk = split_rows(self.mesh, self.row_axes, len(xb))
                x = xb[blk].to(dev)
                wgt = wgt_all[blk].to(dev)
                landmarks = xb[l_idx].to(dev)             # [L, d] replicated
            diag = spec.diag(x)

            first = state is None
            if first:
                # k-means++ seeds FROM THE LANDMARK SET (the reference's
                # distributed adaptation: single-pass and rank-local)
                seeds = kmeans_pp_indices(landmarks, spec.diag(landmarks),
                                          gen, n_clusters=cfg.n_clusters,
                                          spec=spec)
                seed_x = landmarks[seeds]
                u0, k_tilde = assign_to_medoids(x, diag, seed_x,
                                                spec.diag(seed_x), spec=spec)
                state_in = GlobalState(seed_x, spec.diag(seed_x),
                                       torch.zeros(cfg.n_clusters,
                                                   device=dev), 0)
            else:
                u0, k_tilde = assign_to_medoids(x, diag, state.medoids,
                                                state.medoid_diag, spec=spec)
                state_in = state
            with tally() as bill:
                res = _inner_local(self.mesh, x, landmarks, l_idx.to(dev),
                                   diag, u0, wgt, cfg=self.inner_cfg)
            with span("obs:merge"):
                state, disp = self._medoid_merge(xb, x, diag, res, k_tilde,
                                                 state_in, first, wgt)
            history.append(batch_stats(res, disp))
            if checkpoint_cb is not None:
                checkpoint_cb(state, i)
            if rec.enabled:
                dt = time.perf_counter() - t_batch
                # the measured bill of the inner fit: its syncs (the
                # prologue's included), not the argmins' gathers
                rec.counter("collectives/psum", bill.psum, batch=i)
                rec.counter("collectives/allgather", bill.allgather, batch=i)
                rec.counter("collectives/psum_bytes", bill.psum_bytes,
                            batch=i)
                rec.series("batch/wall_seconds", dt, batch=i, rows=n)
                rec.series("inner/cost", history[-1].cost, batch=i)
                rec.series("inner/iters", res.n_iter, batch=i)
                obs_memory.watermark(
                    rec, batch=i, device=dev,
                    engine=self.inner_cfg.engine.mode,
                    predicted_bytes=obs_memory.predicted_batch_footprint(
                        self._priced_cfg, len(xb), xb.shape[1],
                        n_devices=self.d_size))
                # one process a device: the timing unit is this rank
                rank = dist.get_rank() if dist.is_initialized() else 0
                monitor.observe(i, {rank: dt}, n_rows=len(xb))
                rec.batch_boundary(i)
        if state is None:
            raise ValueError("empty batch iterable")
        return FitResult(state, history, spec=cfg.kernel)
