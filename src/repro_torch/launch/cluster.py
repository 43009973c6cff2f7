"""Clustering launcher, the production entry point of the paper's
algorithm; the port of ``repro/launch/cluster.py``.

    python -m repro_torch.launch.cluster --n 100000 --d 64 --clusters 16 [...]
    torchrun --nproc-per-node 4 -m repro_torch.launch.cluster --mesh 4x1 ...

End-to-end flow (paper §3 and §4.2's model selection, automated):

  1. plan (B, s) and the Gram residency from the memory budget a rank
     (Eq.19, ``core.memory.plan``);
  2. build the mesh over the ``torch.distributed`` world, rows split over
     the data axis, landmark columns over model;
  3. run distributed mini-batch kernel k-means
     (``DistributedMiniBatchKMeans``) with a checkpoint after every batch
     (a restart loses at most one mini-batch) and the flight recorder;
  4. report accuracy and NMI against the generating labels, the Fig.4b
     medoid displacement and the inner iterations of every batch.

The world: under ``torchrun`` the launcher joins it from the environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``); run alone it starts a world
of one on a ``FileStore`` in a temporary directory (gloo on the CPU, NCCL
on the card); a world a caller already started is used as it is.
``--mesh AxB`` must have as many ranks as the world (default ``1x1``).
``--device`` names the device (default: the card, ``cuda:LOCAL_RANK``
under torchrun). ``--obs PATH`` writes the recorder's JSONL (rank r > 0
writes ``PATH.rank<r>``); ``--profile DIR`` writes rank 0's profiler trace
of the fit to ``DIR/trace.json``. The reference's ``--platform`` is
``--device`` here; ``main`` first stages the NCCL and CUDA process
variables (``launch.env.configure``), the counterpart of its XLA flags.
"""
from __future__ import annotations

import argparse
import datetime
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import (KernelSpec, MachineSpec, MiniBatchConfig,
                              clustering_accuracy, gamma_from_dmax, nmi, plan)
from repro_torch.core.metrics import mean_displacement
from repro_torch.core.minibatch import predict
from repro_torch.data.sampling import split_batches
from repro_torch.data.synthetic import make_blobs
from repro_torch.distributed.mesh import make_test_mesh, mesh_shape
from repro_torch.distributed.outer import DistributedMiniBatchKMeans
from repro_torch.ft.checkpoint import CheckpointManager

from . import env


def join_world(dev: torch.device, tmp: str) -> bool:
    """Join the world torchrun describes, or start a world of one on a
    FileStore in ``tmp`` (gloo on the CPU, NCCL on the card); a world
    already up is used as it is. True when this call started one."""
    if dist.is_initialized():
        return False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=300),
            **kw)
    return True


def _mesh(spec: str, dev: torch.device):
    dims = tuple(int(v) for v in spec.lower().split("x"))
    names = (("data", "model")[:len(dims)] if len(dims) <= 2
             else ("pod", "data", "model"))
    world = dist.get_world_size()
    if int(np.prod(dims)) != world:
        raise ValueError(f"--mesh {spec} has {int(np.prod(dims))} ranks, "
                         f"the world has {world}")
    return make_test_mesh(dict(zip(names, dims)), device=dev.type)


def main(argv=None):
    env.configure()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--clusters", type=int, default=8)
    ap.add_argument("--mesh", default="1x1",
                    help="(data)x(model) ranks; their product must be the "
                    "world size")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    ap.add_argument("--memory-gb", type=float, default=0.5,
                    help="per-rank budget R for the Eq.19 planner")
    ap.add_argument("--s", type=float, default=None,
                    help="override the planned landmark fraction")
    ap.add_argument("--b", type=int, default=None,
                    help="override the planned number of mini-batches")
    ap.add_argument("--sampling", default="stride",
                    choices=["stride", "block"])
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "materialize", "fused", "tiled"],
                    help="Gram residency of the exact inner loop "
                    "(core.engine); auto = the planner's pick")
    ap.add_argument("--s-step", type=int, default=1,
                    help="s-step depth: s Lloyd refinements per global "
                    "sync, so a Lloyd iteration costs (1 all_gather + 1 "
                    "all_reduce) / s")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obs", default=None, metavar="PATH",
                    help="write a repro_torch.obs flight-recorder JSONL "
                    "here (per-batch wall time, collective counts, "
                    "allocator watermarks against the plan)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a profiler trace of the fit to DIR/trace.json")
    args = ap.parse_args(argv)

    dev = env.set_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        started = join_world(dev, tmp)
        try:
            return _run(args, dev)
        finally:
            if started:
                dist.destroy_process_group()


def _run(args, dev: torch.device) -> float:
    mesh = _mesh(args.mesh, dev)
    rank, world = dist.get_rank(), dist.get_world_size()

    # -- data: the synthetic stand-in for the paper's streams
    x, y = make_blobs(args.n, args.d, args.clusters, sep=8.0, seed=args.seed)

    # -- the memory-aware (B, s) plan, §4.2's rationale
    machine = MachineSpec(memory_bytes=args.memory_gb * 1e9,
                          n_processors=world)
    p = plan(args.n, args.clusters, machine, d=args.d, s_step=args.s_step)
    b = args.b or p.b
    s = args.s if args.s is not None else p.s
    gamma = gamma_from_dmax(torch.as_tensor(x[:4096], device=dev))
    mode = p.engine if args.mode == "auto" else args.mode
    print(f"[cluster] N={args.n} d={args.d} C={args.clusters} "
          f"mesh={mesh_shape(mesh)} device={dev}")
    print(f"[cluster] plan: B={b} s={s:.2f} ({p.note}); "
          f"footprint/node {p.footprint/1e6:.1f} MB "
          f"(fused {p.fused_footprint/1e6:.1f} MB); "
          f"engine={mode}; gamma={gamma:.2e}")

    cfg = MiniBatchConfig(n_clusters=args.clusters, n_batches=b, s=s,
                          kernel=KernelSpec("rbf", gamma=gamma),
                          sampling=args.sampling, seed=args.seed,
                          s_step=args.s_step)

    rec = None
    if args.obs:
        from repro_torch.obs import JsonlRecorder, export
        path = args.obs if rank == 0 else f"{args.obs}.rank{rank}"
        rec = JsonlRecorder(path, header=export.run_header(
            device=dev, entry="launch.cluster", plan=p, b=b, s=s,
            engine=str(mode), s_step=args.s_step, rank=rank,
            mesh=mesh_shape(mesh)))
    km = DistributedMiniBatchKMeans(mesh, cfg, mode=mode, recorder=rec)

    cb = None
    if args.ckpt_dir:
        cm = CheckpointManager(args.ckpt_dir)

        def cb(state, i):
            if rank == 0:                  # every rank holds the same state
                cm.save(i, state, extra={"B": b, "s": s})
            dist.barrier()

    profile = args.profile if rank == 0 else None
    if profile:
        from repro_torch.obs import start_profile
        start_profile(profile)
    t0 = time.time()
    try:
        res = km.fit(split_batches(x, b, strategy=args.sampling),
                     checkpoint_cb=cb)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        if profile:
            from repro_torch.obs import stop_profile
            stop_profile()
            print(f"[cluster] profiler trace -> "
                  f"{os.path.join(profile, 'trace.json')}")
        if rec is not None:
            rec.close()
    dt = time.time() - t0

    labels = predict(x, res.state.medoids, res.state.medoid_diag,
                     spec=cfg.kernel, device=dev).cpu().numpy()
    acc = clustering_accuracy(y, labels)
    disp = mean_displacement(res.history)
    print(f"[cluster] {dt:.2f}s  acc={acc:.4f} nmi={nmi(y, labels):.4f}")
    print(f"[cluster] displacement/batch (Fig.4b): "
          f"{np.array2string(disp, precision=4)}")
    print(f"[cluster] inner iters/batch: "
          f"{[h.inner_iters for h in res.history]}")
    if args.obs:
        from repro_torch.obs import export
        summary = export.summarize(rec.path)
        print(f"[cluster] obs: {summary['events']} events -> {rec.path}")
    return acc


if __name__ == "__main__":
    main()
