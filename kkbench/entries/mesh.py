"""The production mesh entry: ``distributed.outer.DistributedMiniBatchKMeans``
on a 1-D ``data`` mesh over a ``torch.distributed`` world (NCCL on the
card, gloo on the CPU), then ``FitResult.predict``. Every rank is handed
the whole host mini-batch, as the program's fit takes it; the harness
stages the stride batches on the host once, in set-up. B comes from
``core.memory.plan`` with ``n_processors`` the world size. A world of
several is the harness's (``kkbench/world.py``); where none is up, this
process starts a world of one itself, on a ``FileStore`` in a fresh
directory under ``TMPDIR``, removed on ``close``."""
from __future__ import annotations

import shutil
import tempfile

import torch
import torch.distributed as dist

from repro_torch.core.kernels import KernelSpec
from repro_torch.core.minibatch import MiniBatchConfig
from repro_torch.distributed.mesh import make_test_mesh
from repro_torch.distributed.outer import DistributedMiniBatchKMeans
from repro_torch.obs import memory as obs_memory

from . import Shape, StepOut
from .fit_dataset import plan


class Runner:
    def __init__(self, cell: dict, data, gamma: float, device):
        self.cell, self.data, self.device = cell, data, torch.device(device)
        self.spec = KernelSpec("rbf", gamma=gamma)
        self._store_dir = None
        if not dist.is_initialized():
            self._store_dir = tempfile.mkdtemp(prefix="kkbench-world-")
            store = dist.FileStore(f"{self._store_dir}/store", 1)
            if self.device.type == "cuda":
                dist.init_process_group("nccl", store=store, rank=0,
                                        world_size=1,
                                        device_id=torch.device("cuda", 0))
            else:
                dist.init_process_group("gloo", store=store, rank=0,
                                        world_size=1)
        self.world = dist.get_world_size()
        self.mesh = make_test_mesh({"data": self.world},
                                   device=self.device.type)
        n, d = data.x.shape
        p = plan(cell, n, d, self.world)
        self.b, self.engine = p.b, p.gram_engine()
        # the stride batches staged once, as a caller hands its batches to
        # the fit: contiguous and pinned on the host
        xh = data.x.cpu()
        self.host = [xh[i::self.b].contiguous().pin_memory()
                     if self.device.type == "cuda" else xh[i::self.b]
                     for i in range(self.b)]
        del xh
        nb = -(-n // self.b)
        self.shape = Shape(
            engine=self.engine.mode, world=self.world,
            predicted_bytes=obs_memory.predicted_batch_footprint(
                self.config(0), nb, d, n_devices=self.world))

    def config(self, seed: int) -> MiniBatchConfig:
        c = self.cell
        return MiniBatchConfig(
            n_clusters=c["n_clusters"], n_batches=self.b, s=c["s"],
            kernel=self.spec, max_inner_iters=c["max_inner_iters"],
            sampling=c["sampling"], seed=seed, engine=self.engine,
            precision=c["precision"])

    def warm(self) -> None:
        km = DistributedMiniBatchKMeans(self.mesh, self.config(0))
        km.fit(self.host[:2]).predict(self.data.x_test)

    def step(self, seed: int) -> StepOut:
        states = []
        km = DistributedMiniBatchKMeans(self.mesh, self.config(seed))
        res = km.fit(self.host,
                     checkpoint_cb=lambda st, i: states.append(st))
        labels = res.predict(self.data.x_test)
        return StepOut(seed=seed, history=res.history, states=states,
                       labels=labels, rows=[len(b) for b in self.host])

    def close(self) -> None:
        if self._store_dir is not None:
            dist.destroy_process_group()
            shutil.rmtree(self._store_dir, ignore_errors=True)
