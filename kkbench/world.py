"""A world of P processes for a cell whose ``world`` is above 1: rank r on
device r (``cuda:r`` over NCCL; the CPU over gloo in the tests), meeting
on a ``FileStore`` in a fresh directory under ``TMPDIR``.

The process that runs the cell (``kkbench.run``, ``kkbench.calibrate``)
is rank 0; on the card it has set its host threads in its environment
(``pin_threads``) before torch started. ``start`` launches ranks 1..P-1
as ``python3 -m kkbench.run --rank r --store DIR``, which inherit that
environment and print nothing to standard output: each
follows, running every run that rank 0 posts (``begin``) as rank 0 runs
it, until rank 0 closes the world. Rank 0 builds the program's kernels
before it joins the world, and the others wait for it there, so one build
writes the checkout's ``build/``.

Control passes through the store, never the devices: rank 0's decision at
each step boundary (``agree``), and what each rank hands the others after
the window (``exchange``). A rank that dies ends the world: rank 0 watches
its followers and each follower its parent, and exits, or makes them
exit, when one is lost."""
from __future__ import annotations

import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
#: seconds a rank waits on the store or a collective before it gives up
TIMEOUT = 900


class World:
    """This process's rank in a world of ``size`` (a world of one holds no
    store and runs nothing but itself)."""

    def __init__(self, rank: int = 0, size: int = 1, store=None,
                 root: str | None = None, procs=()):
        self.rank, self.size, self.store, self.root = rank, size, store, root
        self.procs = list(procs)
        self.runs = 0           # runs posted (rank 0) or followed
        self.keys = 0           # keys of the current run
        self.closing = False

    def device(self, kind: str) -> torch.device:
        return torch.device("cuda", self.rank) if kind == "cuda" else \
            torch.device(kind)

    def _key(self, name: str) -> str:
        return f"kkbench/{self.runs}/{name}"

    def agree(self, done: bool) -> bool:
        """Rank 0's ``done``, on every rank: whether the window ends at
        this step boundary."""
        if self.size == 1:
            return done
        key = self._key(f"step{self.keys}")
        self.keys += 1
        if self.rank == 0:
            self.store.set(key, "1" if done else "0")
            return done
        return self.store.get(key) == b"1"

    def exchange(self, name: str, obj) -> list:
        """Every rank's ``obj`` (a JSON value), in rank order, on every
        rank."""
        if self.size == 1:
            return [obj]
        self.store.set(self._key(f"{name}/{self.rank}"), json.dumps(obj))
        return [json.loads(self.store.get(self._key(f"{name}/{r}")))
                for r in range(self.size)]

    def same(self, *tensors) -> None:
        """Raise unless every rank holds the same ``tensors``: a float64
        checksum of each (its rows' sums, and their sum weighted by row
        number), compared exactly."""
        sums = []
        for t in tensors:
            rows = t.reshape(t.shape[0], -1).sum(dim=1, dtype=torch.float64)
            w = torch.arange(1, rows.shape[0] + 1, dtype=torch.float64,
                             device=rows.device)
            sums += [float(rows.sum()), float((rows * w).sum())]
        got = self.exchange("checksum", sums)
        if any(g != got[0] for g in got):
            raise RuntimeError(f"the ranks made different data: {got}")

    def begin(self, spec) -> None:
        """Rank 0: post the next run to the followers."""
        self.runs += 1
        self.keys = 0
        if self.size > 1:
            self.store.set(f"kkbench/run{self.runs}", json.dumps(spec))

    def next(self):
        """A follower: the next run rank 0 posts (None: the world ends)."""
        self.runs += 1
        self.keys = 0
        return json.loads(self.store.get(f"kkbench/run{self.runs}"))

    def close(self) -> None:
        """Rank 0: end the followers' loop, leave the world, wait for every
        follower to exit and remove the store's directory."""
        if self.size == 1:
            return
        self.closing = True
        try:
            self.store.set(f"kkbench/run{self.runs + 1}", "null")
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            for p in self.procs:
                try:
                    p.wait(timeout=120)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            shutil.rmtree(self.root, ignore_errors=True)


def _join(root: str, rank: int, size: int, kind: str) -> World:
    store = dist.FileStore(os.path.join(root, "store"), size)
    store.set_timeout(datetime.timedelta(seconds=TIMEOUT))
    timeout = datetime.timedelta(seconds=TIMEOUT)
    if kind == "cuda":
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", store=store, rank=rank,
                                world_size=size, timeout=timeout,
                                device_id=torch.device("cuda", rank))
    else:
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=size, timeout=timeout)
    return World(rank, size, store, root)


def _watch(world: World) -> None:
    """Rank 0: a follower that exits before the world closes ends it."""
    while True:
        time.sleep(0.5)
        for r, p in enumerate(world.procs, start=1):
            code = p.poll()
            if code is not None and not world.closing:
                print(f"kkbench: rank {r} exited with code {code}; ending "
                      "the world", file=sys.stderr, flush=True)
                for q in world.procs:
                    if q.poll() is None:
                        q.kill()
                os._exit(4)
        if world.closing:
            return


def start(size: int, kind: str) -> World:
    """Rank 0 of a world of ``size`` on devices of ``kind`` (``cuda`` or
    ``cpu``): the followers launched, the kernels built, the world
    joined."""
    root = tempfile.mkdtemp(prefix="kkbench-world-")
    (Path(root) / "world.json").write_text(json.dumps({"size": size,
                                                      "kind": kind}))
    procs = []
    try:
        for r in range(1, size):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "kkbench.run", "--rank", str(r),
                 "--store", root], cwd=ROOT, stdin=subprocess.DEVNULL,
                stdout=subprocess.DEVNULL))
        if kind == "cuda":
            from .entries import build_kernels
            build_kernels()
        world = _join(root, 0, size, kind)
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        shutil.rmtree(root, ignore_errors=True)
        raise
    world.procs = procs
    threading.Thread(target=_watch, args=(world,), daemon=True).start()
    return world


def _orphaned(parent: int) -> None:
    """A follower: exit once rank 0, its parent, is gone."""
    while True:
        time.sleep(1.0)
        if os.getppid() != parent:
            os._exit(5)


def follow(rank: int, root: str, run_spec) -> int:
    """A follower's whole life: join the world rank 0 made in ``root``, run
    each posted run with ``run_spec(spec, world)``, leave when it closes.
    A run that fails makes this process exit non-zero, which ends the
    world."""
    threading.Thread(target=_orphaned, args=(os.getppid(),),
                     daemon=True).start()
    meta = json.loads((Path(root) / "world.json").read_text())
    if meta["kind"] == "cpu":
        torch.set_num_threads(1)
    world = _join(root, rank, meta["size"], meta["kind"])
    while (spec := world.next()) is not None:
        run_spec(spec, world)
        if meta["kind"] == "cuda":
            torch.cuda.empty_cache()
    dist.destroy_process_group()
    return 0
