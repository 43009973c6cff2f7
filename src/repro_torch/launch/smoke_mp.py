"""One rank of the multi-process smoke (spawned by
``python -m repro_torch.launch.dryrun_cluster --smoke-mp P``), the port of
``repro/launch/smoke_mp.py``.

Each rank joins a P-process world on the FileStore the driver names
(``REPRO_SMOKE_STORE``, ``REPRO_SMOKE_RANK``, ``REPRO_SMOKE_NPROCS``),
runs ``DistributedMiniBatchKMeans`` with ``--s-step`` on the reference's
blobs (1024 x 8, C = 4, B = 2, materialize) over a (P,) data mesh, and
labels every row by its medoids. ``--device`` defaults to the card: NCCL,
rank r on ``cuda:r``, so P may not exceed the visible cards (the rank
raises and names ``--device cpu`` when it does); ``--device cpu`` runs
the plain path over gloo. ``--obs PATH`` writes rank 0's flight-recorder
log.

Exit codes: 0 ok, 1 a smoke assertion failed (a non-finite inner cost, or
accuracy < 0.95 on blobs that are trivially separable), 75 (EX_TEMPFAIL)
when this torch has no gloo backend for a CPU world; the driver maps 75
to a skip. Any other failure to start the world raises.
"""
from __future__ import annotations

import argparse
import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

SKIP_EXIT = 75


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--s-step", type=int, default=2)
    ap.add_argument("--obs", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default; NCCL, one rank a card) or cpu "
                         "(gloo)")
    args = ap.parse_args(argv)

    rank = int(os.environ["REPRO_SMOKE_RANK"])
    nprocs = int(os.environ["REPRO_SMOKE_NPROCS"])
    dev = rank_device(args.device, rank, nprocs)
    if dev.type == "cpu":
        if not (dist.is_available() and dist.is_gloo_available()):
            print(f"[skip] rank {rank}: this torch has no gloo backend")
            return SKIP_EXIT
        torch.set_num_threads(1)
        backend, kw = "gloo", {}
    else:
        torch.cuda.set_device(dev)
        backend, kw = "nccl", {"device_id": dev}
    dist.init_process_group(
        backend, store=dist.FileStore(os.environ["REPRO_SMOKE_STORE"],
                                      nprocs),
        rank=rank, world_size=nprocs,
        timeout=datetime.timedelta(seconds=120), **kw)
    try:
        return _run(args, rank, nprocs, dev)
    finally:
        dist.destroy_process_group()


def rank_device(device, rank: int, nprocs: int) -> torch.device:
    """The rank's device: ``cuda:rank`` unless ``device`` is ``cpu``;
    raises, naming ``--device cpu``, when the world has more ranks than
    there are visible cards."""
    dev = torch.device(device or "cuda")
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: the smoke runs its "
                           "ranks on the card by default; pass --device "
                           "cpu to run them over gloo")
    have = torch.cuda.device_count()
    if nprocs > have:
        raise RuntimeError(
            f"--smoke-mp {nprocs} on the card needs {nprocs} visible CUDA "
            f"devices (one a rank), this machine has {have}; pass --device "
            f"cpu to run the ranks over gloo")
    return torch.device("cuda", rank)


def _run(args, rank: int, nprocs: int, dev: torch.device) -> int:
    from repro_torch.core import (KernelSpec, MiniBatchConfig,
                                  clustering_accuracy)
    from repro_torch.core.minibatch import predict
    from repro_torch.data.sampling import split_batches
    from repro_torch.data.synthetic import make_blobs
    from repro_torch.distributed import (DistributedMiniBatchKMeans,
                                         make_test_mesh)

    mesh = make_test_mesh({"data": nprocs}, device=dev.type)
    # the same host data on every rank (same seed): the SPMD contract
    x, y = make_blobs(1024, 8, 4, sep=8.0, seed=0)
    cfg = MiniBatchConfig(n_clusters=4, n_batches=2, s=1.0,
                          kernel=KernelSpec("rbf", gamma=2.0), seed=0,
                          s_step=args.s_step)
    rec = None
    if rank == 0 and args.obs:
        from repro_torch.obs import JsonlRecorder, export
        rec = JsonlRecorder(args.obs, header=export.run_header(
            device=dev.type, entry="dryrun_cluster.smoke_mp", nprocs=nprocs,
            s_step=args.s_step))
    km = DistributedMiniBatchKMeans(mesh, cfg, mode="materialize",
                                    recorder=rec)
    try:
        res = km.fit(split_batches(x, cfg.n_batches, strategy="stride"))
    finally:
        if rec is not None:
            rec.close()
    labels = predict(x, res.state.medoids, res.state.medoid_diag,
                     spec=cfg.kernel, device=dev).cpu().numpy()
    acc = clustering_accuracy(y, labels)
    costs = [h.cost for h in res.history]
    if rank == 0:
        print(f"[smoke] {nprocs} processes on {dev.type}, "
              f"s_step={args.s_step}: "
              f"acc={acc:.4f} iters={[h.inner_iters for h in res.history]} "
              f"costs={[round(c, 4) for c in costs]}")
    if not all(np.isfinite(costs)):
        print(f"[FAIL] rank {rank}: non-finite inner cost {costs}")
        return 1
    if acc < 0.95:   # 4 blobs at sep=8 are trivially separable
        print(f"[FAIL] rank {rank}: accuracy {acc:.4f} < 0.95")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
