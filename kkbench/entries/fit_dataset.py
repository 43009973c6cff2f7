"""The single-process entry: ``core.minibatch.fit_dataset`` on the resident
training set, then ``FitResult.predict`` on the held-out rows. An exact
cell takes (B, engine) from ``core.memory.plan`` at the configuration's
``memory_gb``; an embedded cell names its B."""
from __future__ import annotations

import torch

from repro_torch.core import memory as cm
from repro_torch.core.kernels import KernelSpec
from repro_torch.core.minibatch import MiniBatchConfig, fit, fit_dataset
from repro_torch.obs import memory as obs_memory

from . import Shape, StepOut


def plan(cell: dict, n: int, d: int, world: int):
    return cm.plan(n, cell["n_clusters"],
                   cm.MachineSpec(memory_bytes=cell["memory_gb"] * 1e9,
                                  n_processors=world),
                   d=d, precision=cell["precision"])


class Runner:
    def __init__(self, cell: dict, data, gamma: float, device):
        self.cell, self.data, self.device = cell, data, torch.device(device)
        self.spec = KernelSpec("rbf", gamma=gamma)
        n, d = data.x.shape
        if cell["method"] == "exact":
            p = plan(cell, n, d, 1)
            self.b, self.engine = p.b, p.gram_engine()
            predicted = obs_memory.predicted_batch_footprint(
                self.config(0), -(-n // self.b), d)
        else:
            self.b, self.engine = int(cell["batches"]), None
            # the price the embedded loop's own watermark gives a batch
            predicted = cm.embed_footprint_bytes(
                -(-n // self.b), 1, cell["n_clusters"], 1,
                m=cell["embed_dim"], d=d)
        self.shape = Shape(engine=(self.engine.mode if self.engine
                                   else cell["method"]),
                           world=1, predicted_bytes=predicted)

    def config(self, seed: int) -> MiniBatchConfig:
        c = self.cell
        kw = dict(n_clusters=c["n_clusters"], n_batches=self.b, s=c["s"],
                  kernel=self.spec, max_inner_iters=c["max_inner_iters"],
                  sampling=c["sampling"], seed=seed, method=c["method"],
                  precision=c["precision"])
        if self.engine is not None:
            kw["engine"] = self.engine
        if c["method"] != "exact":
            kw["embed_dim"] = c["embed_dim"]
        return MiniBatchConfig(**kw)

    def warm(self) -> None:
        """The cell's own shapes: its first two stride batches (the first
        batch's and a later batch's path), then predict."""
        cfg = self.config(0)
        x = self.data.x
        batches = [x[i::self.b] for i in range(min(2, self.b))]
        res = fit(batches, cfg, device=self.device)
        res.predict(self.data.x_test)

    def step(self, seed: int) -> StepOut:
        states = []
        res = fit_dataset(self.data.x, self.config(seed), device=self.device,
                          checkpoint_cb=lambda st, i: states.append(st))
        labels = res.predict(self.data.x_test)
        n = self.data.x.shape[0]
        rows = [len(range(i, n, self.b)) for i in range(self.b)]
        return StepOut(seed=seed, history=res.history, states=states,
                       labels=labels, rows=rows, fmap=res.fmap)

    def close(self) -> None:
        pass
