"""End-to-end example of the PyTorch port: the paper's §4.5 MD scenario on a
synthetic trajectory (the paper's kind is clustering, so this is the
port's end-to-end production example).

    PYTHONPATH=src python examples/torch_cluster_md_trajectory.py  # the card
    PYTHONPATH=src python examples/torch_cluster_md_trajectory.py \\
        --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 8 \\
        examples/torch_cluster_md_trajectory.py --mesh 4x2 --device cpu

The port of ``examples/cluster_md_trajectory.py``. Pipeline: frames ->
memory-planned (B, s) (``core.plan``, Eq.19) -> stride sampling ->
distributed mini-batch kernel k-means (``distributed.outer.
DistributedMiniBatchKMeans``, ``--restarts`` k-means++ restarts keeping
the lowest cost; ``--engine`` picks the inner loop's Gram residency) ->
medoid extraction -> the elbow over C (``--elbow``)
-> the displacement diagnostic, with a checkpoint after every batch
(``ft.checkpoint.CheckpointManager``, rank 0 writes). ``--mesh DxM`` is
the (data, model) mesh of the ``torch.distributed`` world
(``launch.mesh.launcher_mesh``): under ``torchrun`` the world it
describes (gloo with ``--device cpu``), run alone a world of one on a
FileStore (gloo on the CPU, NCCL on the card; the card's machine has one
card, so a mesh there is a world of one). ``main`` returns the printed
numbers (rank 0's; every rank holds the same state).
"""
import argparse
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import (KernelSpec, MachineSpec, MiniBatchConfig,
                              clustering_accuracy, elbow, gamma_from_dmax,
                              mean_displacement, nmi, plan)
from repro_torch.core.minibatch import predict
from repro_torch.data.sampling import split_batches
from repro_torch.data.synthetic import make_md_trajectory
from repro_torch.distributed.outer import DistributedMiniBatchKMeans
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.launch import env
from repro_torch.launch.cluster import join_world
from repro_torch.launch.mesh import launcher_mesh


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20000)
    ap.add_argument("--atoms", type=int, default=32)
    ap.add_argument("--states", type=int, default=8)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--restarts", type=int, default=5)
    ap.add_argument("--memory-gb", type=float, default=0.2)
    ap.add_argument("--elbow", action="store_true",
                    help="sweep C over (4, 12) with the elbow criterion")
    ap.add_argument("--engine", default="materialize",
                    choices=("materialize", "fused", "tiled"),
                    help="Gram residency of the inner loop (core.engine; "
                    "fused: the assign_fused kernel rebuilds each Gram tile "
                    "in the sweep); MiniBatchConfig's default, "
                    "materialize, is the reference example's")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    args = ap.parse_args(argv)

    dev = env.set_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        started = join_world(dev, tmp)
        try:
            return _run(args, dev)
        finally:
            if started:
                dist.destroy_process_group()


def _run(args, dev) -> dict:
    mesh = launcher_mesh(args.mesh, dev)
    rank, world = dist.get_rank(), dist.get_world_size()
    say = print if rank == 0 else (lambda *a, **k: None)
    x, y = make_md_trajectory(args.frames, args.atoms, args.states,
                              dwell=400.0, seed=0)
    say(f"[md] {args.frames} frames, d={x.shape[1]} ({args.atoms} atoms), "
        f"{args.states} metastable states, mesh {args.mesh} on {dev}")

    # the memory-aware plan (Eq.19): the paper used ~250k-frame batches
    machine = MachineSpec(memory_bytes=args.memory_gb * 1e9,
                          n_processors=world)
    p = plan(len(x), args.states, machine, d=x.shape[1])
    gamma = gamma_from_dmax(torch.as_tensor(x[:4096], device=dev))
    say(f"[md] plan: B={p.b} s={p.s} ({p.note}), gamma={gamma:.2e}, "
        f"engine {args.engine}")
    out = {"b": p.b, "s": p.s}

    def fit(c, seed, cb=None):
        cfg = MiniBatchConfig(n_clusters=c, n_batches=p.b, s=p.s,
                              kernel=KernelSpec("rbf", gamma=gamma),
                              sampling="stride", seed=seed)
        km = DistributedMiniBatchKMeans(mesh, cfg, mode=args.engine)
        return cfg, km.fit(split_batches(x, p.b, "stride"), checkpoint_cb=cb)

    n_clusters = args.states
    if args.elbow:
        cs = list(range(4, 13, 2))
        costs = [fit(c, 0)[1].history[-1].cost for c in cs]
        n_clusters = cs[elbow(costs)]
        out["elbow"] = {"cs": cs, "costs": costs, "c": n_clusters}
        say(f"[md] elbow over C={cs}: costs={np.round(costs, 1)} "
            f"-> C*={n_clusters}")

    # restarts, keeping the minimum cost (paper §4.5)
    best, best_cost = None, np.inf
    t0 = time.time()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        for r in range(args.restarts):
            cm = CheckpointManager(f"{ckpt_dir}/run{r}")

            def cb(state, i, cm=cm):
                if rank == 0:          # every rank holds the same state
                    cm.save(i, state)
                dist.barrier()
            cfg, res = fit(n_clusters, r, cb)
            cost = res.history[-1].cost
            say(f"[md] restart {r}: final batch cost {cost:.1f}, "
                f"iters={[h.inner_iters for h in res.history]}")
            if cost < best_cost:
                best, best_cost, best_cfg = res, cost, cfg
            out["checkpoints"] = cm.latest_step() if rank == 0 else None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0

    labels = predict(x, best.state.medoids, best.state.medoid_diag,
                     spec=best_cfg.kernel, device=dev).cpu().numpy()
    disp = mean_displacement(best.history)
    out.update(acc=clustering_accuracy(y, labels), nmi=nmi(y, labels),
               seconds=dt, cost=best_cost)
    say(f"[md] {args.restarts} restarts in {dt:.1f}s")
    say(f"[md] acc={out['acc']:.4f} nmi={out['nmi']:.4f} (vs {args.states} "
        f"true states)")
    say(f"[md] displacement/batch (sampling-quality, Fig.4b): "
        f"{np.array2string(disp, precision=4)}")
    # medoids are actual frames: directly inspectable structures (§4.5)
    norms = torch.linalg.vector_norm(best.state.medoids.float(), dim=1)
    say(f"[md] medoid frame norms: {norms.cpu().numpy().round(1)}")
    return out


if __name__ == "__main__":
    main()
