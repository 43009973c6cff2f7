"""Elastic execution of the clustering outer loop, the port of
``repro/ft/elastic.py``.

The mini-batch boundary is the natural failure and rescale domain: the
global state is O(C*d) (exact) or O(C*m) (embedded) and does not depend on
the mesh, and the memory plan (Eq.19, ``core/memory.py``) is a function of
(N, C, P, R). So on a mesh change the runner re-plans for the new number
of row shards and resumes from the last committed checkpoint, losing at
most one mini-batch of work.

``run`` takes any batch iterable or a ``data.loader.BatchSource``; on
resume the committed prefix is skipped host-side (never staged), and the
source is closed on every exit path, so a producer thread survives neither
a failure nor a re-mesh.

Embedded methods checkpoint the drawn feature map beside the
``EmbedState``: the map is part of the model, and a restart (on any mesh)
must embed with the same parameters. The manifest records the landmark
selector, the map's m and d, the batch shape and the row shards the state
was committed on. Every rank holds the same state, so the world's first
rank writes the checkpoints, a barrier after each write commits it, and
every rank reads them: the checkpoint directory must be one that every
rank sees. A streaming
selection pre-pass
(``approx.selectors.select_streaming``) checkpoints its ``SelectorState``
through the same ``CheckpointManager``.

``recorder=`` (``repro_torch.obs``) is handed to the mesh runner, and the
runner adds an ``elastic/resume`` event at the start of ``run`` and an
``elastic/checkpoint`` event at every commit, next to the per-batch
records.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from repro_torch.approx.embed_kmeans import EmbedState
from repro_torch.core.minibatch import FitResult, GlobalState, MiniBatchConfig
from repro_torch.data.loader import BatchSource, closing_source
from repro_torch.data.sparse import as_csr, is_sparse
from repro_torch.distributed.embed import DistributedEmbedKMeans
from repro_torch.distributed.mesh import (axis_size, mesh_device, mesh_shape,
                                          row_axes_of)
from repro_torch.distributed.outer import DistributedMiniBatchKMeans
from repro_torch.obs import resolve as resolve_recorder

from .checkpoint import CheckpointManager


class ElasticClusteringRunner:
    def __init__(self, cfg: MiniBatchConfig, ckpt: CheckpointManager, *,
                 mode: object = None, prefetch: int = 0, machine=None,
                 recorder=None):
        """``mode`` overrides the exact inner loop's GramEngine (default
        ``cfg.engine``: a restart never demotes the configured residency).
        ``prefetch`` stages batches on a producer thread. ``machine`` is
        the ``core.memory.MachineSpec`` of one rank that a re-plan prices
        against (default: one H100). ``recorder``: see the module
        docstring."""
        self.rec = resolve_recorder(recorder)
        self.cfg = cfg
        self.ckpt = ckpt
        self.mode = mode
        self.prefetch = prefetch
        self.machine = machine
        self.plan = None        # the last re-plan, on a mesh change
        self._shape = None      # (rows, d) of the last batch consumed

    # -- checkpoint structure ------------------------------------------------

    def _fmap_like(self, extra: dict, device):
        """A map of the checkpointed kind and statics (m from the manifest,
        the rest from the config) whose leaves the restore replaces."""
        from repro_torch import approx
        m, d = int(extra["m"]), int(extra["d"])
        sample = torch.zeros((max(m, 2), d), device=device)
        return approx.make_feature_map(
            self.cfg.method, torch.Generator().manual_seed(0), sample, m,
            self.cfg.kernel, orthogonal=self.cfg.rff_orthogonal)

    def _restore(self, device):
        """-> (state | None, fmap | None, extra) of the latest step."""
        step = self.ckpt.latest_step()
        if step is None:
            return None, None, {}
        extra = self.ckpt.extra(step)
        zero = torch.zeros(1)
        if self.cfg.method == "exact":
            like = GlobalState(zero, zero, zero, 0)
            return self.ckpt.restore(step, like, device=device), None, extra
        like = {"state": EmbedState(zero, zero, 0),
                "fmap": self._fmap_like(extra, device)}
        got = self.ckpt.restore(step, like, device=device)
        return got["state"], got["fmap"], extra

    def _replan(self, extra: dict, shards: int) -> None:
        """On a mesh change, price the committed batch shape on the new
        number of row shards (``core.memory.plan``); raises where even the
        configured residency does not fit one rank."""
        from repro_torch.core.engine import resolve_engine
        from repro_torch.core.memory import MachineSpec, plan
        if "rows" not in extra or int(extra.get("shards", shards)) == shards:
            return
        cfg = self.cfg
        machine = dataclasses.replace(self.machine or MachineSpec(),
                                      n_processors=shards)
        self.plan = plan(int(extra["rows"]) * cfg.n_batches, cfg.n_clusters,
                         machine, d=int(extra["d_rows"]), b=cfg.n_batches,
                         precision=cfg.precision, s_step=cfg.s_step)
        if cfg.method == "exact":
            mode = resolve_engine(cfg.engine if self.mode is None
                                  else self.mode).mode
            need = self.plan.engine_footprints[mode]
        else:
            need = self.plan.embed_footprint
        if need > machine.memory_bytes:
            raise ValueError(
                f"resuming on {shards} row shards: a batch of "
                f"{extra['rows']} rows needs {need / 1e9:.2f} GB a rank, "
                f"more than {machine.memory_bytes / 1e9:.2f} GB")

    def _watch(self, src):
        """Yield the source's batches, noting the shape of each."""
        for b in src:
            host = b.host if hasattr(b, "host") else b
            shape = as_csr(host).shape if is_sparse(host) else tuple(
                host.shape)
            self._shape = (int(shape[0]), int(shape[1]))
            yield b

    # -- the fit loop --------------------------------------------------------

    def run(self, mesh, batches: Iterable, *,
            fail_after: Optional[int] = None) -> FitResult:
        """Run (or resume) on ``mesh``. ``fail_after=k`` injects a
        simulated failure after k mini-batches (tests, chaos drills)."""
        cfg = self.cfg
        dev = mesh_device(mesh)
        shards = axis_size(mesh, row_axes_of(mesh))
        state, fmap, extra = self._restore(dev)
        start = int(state.batches_done) if state is not None else 0
        self._replan(extra, shards)
        rec = self.rec
        rec.event("elastic/resume", start_batch=start,
                  resumed=state is not None, method=cfg.method,
                  mesh_shape=mesh_shape(mesh))

        def meta(i: int) -> dict:
            rows, d = self._shape
            return {"n_batches": cfg.n_batches, "s": cfg.s,
                    "method": cfg.method, "rows": rows, "d_rows": d,
                    "shards": shards, "batch": i}

        # every rank holds the same state: the world's first rank writes
        # it, and a step is committed when every rank has passed the
        # barrier after the write, so a rank that fails next restores what
        # the others do
        writer = not dist.is_initialized() or dist.get_rank() == 0

        def commit(i: int, tree, extra: dict):
            if writer:
                self.ckpt.save(i, tree, extra=extra)
            if dist.is_initialized():
                dist.barrier()
            rec.event("elastic/checkpoint", batch=i)

        if cfg.method == "exact":
            runner = DistributedMiniBatchKMeans(mesh, cfg, mode=self.mode,
                                                recorder=rec)

            def cb(s, i: int):
                commit(i, s, meta(i))
        else:
            runner = DistributedEmbedKMeans(mesh, cfg, fmap=fmap,
                                            recorder=rec)

            def cb(s, i: int):
                from repro_torch.approx.selectors import name_of
                fm = runner.fmap
                commit(i, {"state": s, "fmap": fm}, {
                    **meta(i), "m": fm.dim, "d": fm.in_dim,
                    "selector": name_of(cfg.selector)})

        if isinstance(batches, BatchSource):
            src = batches
        else:
            # the embedded runner stages onto the mesh on the producer
            # thread; the exact runner copies its own row block
            stage = runner.stage if cfg.method != "exact" else (lambda b: b)
            src = BatchSource(batches, prefetch=self.prefetch, stage=stage)
        src.skip(start)     # the committed prefix: dropped, never staged
        with closing_source(src):
            if fail_after is not None:
                consumed = []
                for i, b in enumerate(self._watch(src)):
                    consumed.append(b)
                    if i + 1 >= fail_after:
                        break
                result = runner.fit(self._watch(consumed), state=state,
                                    checkpoint_cb=cb)
                raise SimulatedFailure(result)
            return runner.fit(self._watch(src), state=state,
                              checkpoint_cb=cb)


class SimulatedFailure(RuntimeError):
    def __init__(self, partial: FitResult):
        super().__init__("injected failure")
        self.partial = partial
