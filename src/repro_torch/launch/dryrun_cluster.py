"""Dry run of the paper's algorithm on the production mesh, the port of
``repro/launch/dryrun_cluster.py``:

    python -m repro_torch.launch.dryrun_cluster --all --out build/dryrun
    python -m repro_torch.launch.dryrun_cluster --smoke-mp 2 [--device cpu]

Costs ONE inner-loop sweep (Alg.1 lines 10-14, the unit the paper's
communication bound is stated for) as rank 0 of a fake world of 256 ranks
(the (16, 16) single-pod mesh) or 512 (the (2, 16, 16) multi-pod one),
for four distribution variants:

  paper-1d   faithful Alg.1: rows over all ranks, landmark columns
             replicated, K^i(p) materialized per rank.
  2d         rows over (pod, data), landmark columns over model: the
             per-rank K block shrinks by the model-axis size.
  fused      the Gram block is rebuilt inside the sweep and never stored
             (the assign_fused kernel's structure; on the CPU its plain
             version, priced by ``hlocost.KERNEL_WORK``).
  2d-bf16k   2d with the K block stored in bf16.

Default problem (the reference's production regime): N/B = 1,048,576 rows
x d = 768 f32, C = 64, |L| = 65,536 (s = 1/16).

The world is ``torch.distributed.init_process_group("fake", store=
FakeStore())`` from ``torch.testing._internal.distributed.fake_pg`` (an
internal module, imported here only, never at package import): its
collectives return at once. The mesh is ``launch.mesh.
make_production_mesh``, and the sweep runs under
``torch._subclasses.fake_tensor.FakeTensorMode``, so no tensor holds
storage: nothing is allocated, whatever the problem size, and the costs
come from ``launch.hlocost`` (flops, bytes, kernel work, collective counts
and payload bytes per rank). A host read has no value there
(``DataDependentOutputException``), so the sweep leaves out the loop's
``changed`` flag, as the reference's lowering does. Each cell writes the
reference's JSON schema; ``compile_seconds`` is ``trace_seconds``, the
time of the fake run, since nothing is compiled. The materialize modes
consume a K block given as input and add the Gram evaluation amortized
over 20 sweeps, as the reference does.

``--smoke-mp P`` instead spawns P ranks of ``launch.smoke_mp`` (a real
world on a FileStore, the s-step fit: NCCL with one rank a card by
default, gloo with ``--device cpu``) and maps their exit 75 to a skip.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.core.engine import (GramEngine, ReducePlan,
                                     assign_from_stats, engine_stats)
from repro_torch.core.kernels import KernelSpec
from repro_torch.distributed.mesh import (all_gather, all_reduce, axis_group,
                                         axis_size)
from repro_torch.launch.mesh import make_production_mesh

MODES = {
    # mode -> (row axes (single pod), col axis, inner mode, K dtype)
    "paper-1d": (("data", "model"), None, "materialize", torch.float32),
    "2d": (("data",), "model", "materialize", torch.float32),
    "fused": (("data",), "model", "fused", torch.float32),
    "2d-bf16k": (("data",), "model", "materialize", torch.bfloat16),
}
AMORTIZE_SWEEPS = 20.0       # typical inner iterations per batch


def _fake_store():
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "dryrun_cluster needs torch.testing._internal.distributed.fake_pg "
            f"(the fake process group) and this torch has none: {e}") from e
    return FakeStore()


def lower_cluster(mode: str, *, multi_pod: bool = False, n_rows: int = 2**20,
                  d: int = 768, c: int = 64, n_landmarks: int = 65536):
    """Cost ONE assignment sweep of ``mode`` as rank 0 of the production
    mesh's fake world (module docstring) -> the cell's JSON dict."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.hlocost import cost_of

    row_axes, col_axis, inner_mode, k_dtype = MODES[mode]
    if multi_pod:
        row_axes = ("pod",) + row_axes
    if dist.is_initialized():
        raise RuntimeError("dryrun_cluster starts its own fake world; run it "
                           "in a process with no torch.distributed world")
    world = 512 if multi_pod else 256
    t0 = time.time()
    dist.init_process_group("fake", store=_fake_store(), rank=0,
                            world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        spec = KernelSpec("rbf", gamma=0.05)
        d_size = axis_size(mesh, row_axes)
        m_size = axis_size(mesh, col_axis) if col_axis else 1
        rows_p, cols_p = n_rows // d_size, n_landmarks // m_size

        # the mesh's ONE batched reduction, as distributed.inner builds it:
        # 2-D reduces counts/f/g in one flat all_reduce over the model
        # axis; 1-D reduces only g over the rows
        if col_axis is not None:
            def fused_reduce(counts_p, f_p, g_p):
                flat = all_reduce(torch.cat([f_p, counts_p[None],
                                             g_p[None]]), mesh, (col_axis,))
                return flat[-2], flat[:-2], flat[-1]
        else:
            def fused_reduce(counts_p, f_p, g_p):
                return counts_p, f_p, all_reduce(g_p, mesh, row_axes)
        plan = ReducePlan(fused_reduce)

        def sweep(op_xl, op_ll, lidx_cols, lidx_rows, u_local, eng):
            u_full = all_gather(u_local, mesh, row_axes)
            f, g, counts = engine_stats(eng, spec, op_xl, op_ll,
                                        u_full[lidx_cols], u_full[lidx_rows],
                                        c, reduce=plan)
            return assign_from_stats(f, g, counts)[0]

        # per-rank shapes: 1-D keeps the landmark rows split over the rows
        # (the paper's layout); 2-D all of them over its column slice
        n_lrows = n_landmarks // d_size if col_axis is None else n_landmarks
        # the groups of several axes are built from the mesh's real rank
        # tensor: before the fake mode
        axis_group(mesh, row_axes)
        with FakeTensorMode():
            lidx_cols = torch.zeros(cols_p, dtype=torch.long)
            lidx_rows = torch.zeros(n_lrows, dtype=torch.long)
            u_local = torch.zeros(rows_p, dtype=torch.int32)
            if inner_mode == "fused":
                eng = GramEngine("fused")
                x_local = torch.empty(rows_p, d)
                lm_cols = torch.empty(cols_p, d)
                lm_rows = torch.empty(n_lrows, d)
                cost = cost_of(lambda: sweep(
                    eng.prepare(spec, x_local, lm_cols),
                    eng.prepare(spec, lm_rows, lm_cols), lidx_cols,
                    lidx_rows, u_local, eng))
                gram = None
            else:
                k_local = torch.empty(rows_p, cols_p, dtype=k_dtype)
                kll_local = torch.empty(n_lrows, cols_p, dtype=k_dtype)
                cost = cost_of(lambda: sweep(
                    GramEngine.from_matrix(k_local),
                    GramEngine.from_matrix(kll_local), lidx_cols, lidx_rows,
                    u_local, GramEngine("materialize")))
                x_local = torch.empty(rows_p, d)
                lm_cols = torch.empty(cols_p, d)
                gram = cost_of(lambda: spec(x_local, lm_cols).to(k_dtype))
    finally:
        dist.destroy_process_group()
    sweep_coll = ({k: v for k, v in cost.coll_counts.items() if v},
                  {k: v for k, v in cost.coll.items() if v})
    allocated = cost.allocated
    memory = {"allocated_bytes": allocated}
    if gram is not None:
        cost += gram.scaled(1.0 / AMORTIZE_SWEEPS)
        memory["allocated_bytes"] += gram.allocated
        memory["k_block_bytes_per_device"] = rows_p * cols_p * \
            torch.empty((), dtype=k_dtype).element_size()

    # useful work per sweep: the f product 2 rows L C, plus the Gram 2 rows
    # L d (all of it for fused, amortized for materialize)
    gram_f = 2.0 * n_rows * n_landmarks * d
    fmat = 2.0 * n_rows * n_landmarks * c
    model_flops = fmat + (gram_f if inner_mode == "fused"
                          else gram_f / AMORTIZE_SWEEPS)
    return {
        "arch": f"kkmeans-{mode}", "shape": "minibatch_1m",
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_params": n_rows * d,
        "n_active_params": n_rows * d,
        "tokens_per_step": n_rows,
        "model_flops_total": model_flops,
        "flops_per_device": cost.flops,
        "bytes_per_device": cost.bytes,
        "loop_aware": {
            "flops_per_device": cost.flops,
            "flops_by_precision": cost.flops_by_precision,
            "bytes_per_device": cost.bytes,
            "collective_bytes_by_kind": cost.coll,
            "collective_counts": cost.coll_counts,
            "collective_bytes": cost.coll_bytes,
        },
        "problem": {"n_rows": n_rows, "d": d, "c": c,
                    "n_landmarks": n_landmarks, "mode": mode,
                    "per_sweep": True, "world": world,
                    "rows_per_rank": rows_p, "cols_per_rank": cols_p},
        "memory_analysis": memory,
        # the sweep's own collectives (the Gram evaluation has none)
        "collectives": {"counts": sweep_coll[0], "bytes_by_kind": sweep_coll[1],
                        "total_bytes": sum(sweep_coll[1].values())},
        "trace_seconds": round(time.time() - t0, 2),
        "ok": True,
    }


def smoke_driver(args) -> int:
    """Spawn ``--smoke-mp`` ranks of ``repro_torch.launch.smoke_mp`` (real
    collectives through the s-step fit, on ``--device``) on a FileStore
    and wait; exit 75 of any rank (no gloo backend for a CPU world) is a
    skip."""
    import subprocess
    import tempfile

    from repro_torch.launch.smoke_mp import SKIP_EXIT, rank_device

    dev = rank_device(args.device, 0, args.smoke_mp)   # raises here, not

    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, REPRO_SMOKE_NPROCS=str(args.smoke_mp),
                   REPRO_SMOKE_STORE=os.path.join(tmp, "store"))
        cmd = [sys.executable, "-m", "repro_torch.launch.smoke_mp",
               "--s-step", str(args.s_step), "--device", dev.type]
        if args.obs:
            cmd += ["--obs", args.obs]
        procs = [subprocess.Popen(cmd, env=dict(env,
                                                REPRO_SMOKE_RANK=str(r)))
                 for r in range(args.smoke_mp)]
        codes = []
        try:
            for p in procs:
                codes.append(p.wait(timeout=300))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if any(c == SKIP_EXIT for c in codes):
        print(f"[skip] no gloo backend for a CPU world here "
              f"(exit codes {codes})")
        return 0
    if any(codes) or len(codes) < len(procs):
        print(f"[FAIL] smoke worker exit codes {codes}")
        return 1
    print(f"[ok] multi-process smoke: {args.smoke_mp} processes clean "
          f"on {dev.type}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description="clustering dry run")
    ap.add_argument("--mode", default=None, choices=sorted(MODES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rows", type=int, default=2**20)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--clusters", type=int, default=64)
    ap.add_argument("--landmarks", type=int, default=65536)
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--smoke-mp", type=int, default=0, metavar="P",
                    help="run the multi-process smoke with P processes "
                         "(real collectives through the s-step fit) "
                         "instead of the dry run")
    ap.add_argument("--s-step", type=int, default=2,
                    help="s-step depth for the smoke fit")
    ap.add_argument("--obs", default=None, metavar="PATH",
                    help="smoke: rank 0's flight-recorder JSONL")
    ap.add_argument("--device", default=None,
                    help="smoke: cuda (default; NCCL, one rank a card) or "
                         "cpu (gloo)")
    args = ap.parse_args(argv)

    if args.smoke_mp:
        raise SystemExit(smoke_driver(args))
    if not args.all and args.mode is None:
        ap.error("one of --mode or --all is required")

    modes = sorted(MODES) if args.all else [args.mode]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    n_fail = 0
    for mode in modes:
        for mp in meshes:
            tag = f"kkmeans-{mode}__minibatch_1m__{'mp' if mp else 'sp'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip] {tag} (cached)")
                continue
            try:
                res = lower_cluster(mode, multi_pod=mp, n_rows=args.rows,
                                    d=args.d, c=args.clusters,
                                    n_landmarks=args.landmarks)
                print(f"[ok]   {tag}  trace={res['trace_seconds']}s "
                      f"coll/sweep="
                      f"{res['loop_aware']['collective_bytes']:.3e}B")
            except Exception as e:
                n_fail += 1
                res = {"arch": f"kkmeans-{mode}", "shape": "minibatch_1m",
                       "mesh": "2x16x16" if mp else "16x16", "ok": False,
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()}
                print(f"[FAIL] {tag}: {type(e).__name__}: {e}")
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
