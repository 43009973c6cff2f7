"""Program audit of every hot path: ``python -m repro_torch.launch.audit``,
the port's counterpart of ``repro/launch/audit.py``.

Runs each hot path the port ships once, at the audit's shapes on
``--device``, under ``analysis.audit`` (the reference traces them without
running; see ``analysis/dispatch.py`` for what that changes), and holds it
to the reference's invariants, report for report (26 reports, the
reference's names, the device in place of its ``tpu`` backend tag):

  * engine modes (``kkmeans_fit[mode,precision]``, 3 modes x 2 tile
    dtypes): the assign_fused kernel (its plain version on the CPU) runs
    iff the mode is fused, as often in every iteration; accumulations in
    kernel scope are f32; the peak stays within a slack of
    ``core.memory.engine_footprint_bytes``'s price; outside materialize
    neither the peak nor any intermediate reaches the [rows, |L|] Gram
    block in the tile dtype; at most the one flag read per iteration; no
    collective;
  * kernel wrappers (``KERNEL_WRAPPERS`` x 2 tile dtypes): each runs its
    kernel, accumulates f32 in kernel scope, and passes the
    **f32-accumulation probe**: inputs exact in bf16 whose f32 sums climb
    past 2^9 in unit steps, where a bf16 accumulator stalls at 256 (a
    linear Gram over 4096 ones is 4096, not 256). On the card the probe
    holds the kernel, on the CPU its plain version. The reference's
    ``--gpu-trace`` and ``--no-interpret`` have no counterpart: the
    Triton/interpret seam (``kernels/backend.py``) is not ported;
  * the mesh program (``distributed_inner[...]``, a (1,) and a (1, 1)
    mesh, s_step 1 and 2): exactly one all_gather and one psum per sync,
    inside the loop and outside it (the prologue sync), against
    ``distributed.inner.collectives_per_iteration``; one loop; at most the
    one flag read per sync, none in the local refinements;
  * the embedded Lloyd mesh program (``embed_lloyd``): one psum per sweep
    and one outside;
  * serving ``predict`` and every dense bucket program of the assignment
    service (``serving_predict``, ``serve_bucket[b]``): loop-free,
    collective-free, no host read; a bucket launches its kernel and
    accumulates f32. A bucket's EAGER program is audited, never a CUDA
    graph's capture or replay (a dispatch mode would be recorded into the
    graph). A warmed ``AssignService`` holds one program per bucket (a
    captured graph on the card, the eager call on the CPU).

``--cost`` attaches ``launch.hlocost``'s terms to every report (the
reference's ``--hlo``; read from the audited run, with no second run).
``--out FILE`` writes every report as JSON. Exit code 1 on any
violation. ``--device`` defaults to the card. The mesh
programs need a ``torch.distributed`` world: ``main`` joins or starts one,
as ``launch.cluster`` does (a world of one on a FileStore: gloo on the
CPU, NCCL on the card).
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile

import torch

from repro_torch.analysis import ProgramReport, audit
from repro_torch.core.engine import ENGINE_MODES, GramEngine
from repro_torch.core.kernels import KernelSpec
from repro_torch.core.memory import engine_footprint_bytes
from repro_torch.kernels.kernel_matrix import VEC
from repro_torch.kernels.precision import PRECISIONS, resolve_precision

#: the eager temporaries a fused device program would not hold (the f32
#: chains of the stats, the bf16 casts beside their f32 sources): the
#: envelope around the planner's price, doubled under bf16, where those
#: f32 chains stay while the price halves. It is NOT the residency guard:
#: the price's feature rows and bookkeeping leave room for a whole
#: [rows, |L|] block inside it (at the defaults, 512 rows and 64-row
#: tiles, in tiled mode at both dtypes and fused bf16; at Tab.1's width
#: in every mode). So outside materialize the peak and the largest
#: intermediate are each held below the block itself, in the tile dtype
#: (``audit_engine_modes``).
MEMORY_SLACK = 4.0

#: every kernel wrapper the port ships, audited at both tile dtypes
KERNEL_WRAPPERS = ("kernel_matrix", "assign_fused", "embed_assign",
                   "sketch_assign", "flash_attention")

#: the probe's contraction depth: 4096 unit steps (a bf16 accumulator
#: stalls at 256, where the step is half its spacing)
PROBE_DEPTH = 4096


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _gen(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def mode_budget(n: int, d: int, n_landmarks: int, c: int, mode: str,
                tile_rows: int, *, precision: str = "f32") -> float:
    """The planner's priced per-iteration footprint at the shapes the port
    allocates. Its only padding is the kernels' vector width on D
    (``kernels/ops.py`` ``_operand``, on the card); the reference's
    128-multiples are TPU blocks and are not copied. ``precision``
    re-prices the tile terms at the tile dtype."""
    d = _round_up(d, VEC[resolve_precision(precision).tile_dtype])
    return engine_footprint_bytes(
        n, 1, c, 1, s=n_landmarks / n, d=d, mode=mode, tile_rows=tile_rows,
        q_tile=2 if precision == "bf16" else None)


def audit_engine_modes(*, n: int, d: int, n_landmarks: int, c: int,
                       tile_rows: int, device,
                       x: torch.Tensor | None = None, gamma: float = 0.5,
                       max_iters: int = 10) -> list:
    """(report, violations) per GramEngine mode x tile dtype on the
    single-host inner loop; no mesh, so any collective is a violation.
    ``x`` (default: normal rows from seed 0) gives the rows; the first
    ``n_landmarks`` are the landmarks, and the labels start round-robin
    so the loop takes more than one pass."""
    from repro_torch.core import kkmeans

    spec = KernelSpec(name="rbf", gamma=gamma)
    if x is None:
        x = torch.randn(n, d, generator=_gen())
    x = x.to(device)
    n, d = x.shape
    l_idx = torch.arange(n_landmarks, device=x.device)
    diag = spec.diag(x)
    labels0 = (torch.arange(n, device=x.device) % c).to(torch.int32)
    out = []
    for mode in ENGINE_MODES:
        for precision in PRECISIONS:
            engine = GramEngine(mode=mode, tile_rows=tile_rows,
                                precision=precision)
            kw = dict(spec=spec, n_clusters=c, max_iters=max_iters,
                      engine=engine)
            report = audit(kkmeans.kkmeans_fit, x, l_idx, diag, labels0,
                           name=f"kkmeans_fit[{mode},{precision}]", **kw)
            budget = mode_budget(n, d, n_landmarks, c, mode, tile_rows,
                                 precision=precision)
            violations = report.check_kernel(mode == "fused", "assign_fused")
            violations += report.check_precision()
            slack = MEMORY_SLACK * (2.0 if precision == "bf16" else 1.0)
            violations += report.check_memory(budget, slack=slack)
            if mode != "materialize":
                # the residency promise: no [rows, |L|] block in the tile
                # dtype, in one tensor or across the peak (the reference
                # prices it at f32 and checks the one tensor)
                block = n * n_landmarks * torch.empty(
                    (), dtype=resolve_precision(precision).tile_dtype
                ).element_size()
                violations += report.check_max_intermediate(block)
                violations += [f"{v} (the [rows, |L|] block)" for v in
                               report.check_memory(block, slack=1.0)]
            violations += report.check_host_sync(per_iteration=1)
            if (report.collectives_per_iteration
                    or report.collectives_outside):
                violations.append(f"{report.name}: collectives in a "
                                  f"single-host program")
            out.append((report, violations))
    return out


# ---------------------------------------------------------------------------
# the kernel wrappers and the f32-accumulation probe


def _probe_cluster_panels(device, m: int):
    """Two centroids over an m-dim embedding: c_0 = e_0 (|c_0|^2 = 1),
    c_1 = 0; so a row's score on cluster 0 is 1 - 2 z_0."""
    cents = torch.zeros(2, m, device=device)
    cents[0, 0] = 1.0
    return cents, torch.ones(2, device=device)


def accumulation_probe(kernel: str, precision: str, device) -> dict:
    """Run ``kernel``'s wrapper on inputs exact in bf16 whose f32 sums
    climb to ``PROBE_DEPTH`` in unit steps -> {"got", "want", "stalled",
    "ok"}: ``stalled`` is what a bf16 accumulator would give."""
    from repro_torch.approx.nystrom import NystromMap
    from repro_torch.approx.sketch import CountSketchMap
    from repro_torch.kernels import ops

    depth = PROBE_DEPTH
    ones = torch.ones(64, depth, device=device)
    if kernel == "kernel_matrix":
        # a wide Y (the tile body on the card) and a skinny one (column)
        got = [float(v) for y_rows in (40, 8)
               for k in [ops.kernel_matrix(ones, ones[:y_rows], kind="linear",
                                           precision=precision)]
               for v in (k.min(), k.max())]
        want, stalled = float(depth), 256.0
    elif kernel == "assign_fused":
        labels_l = torch.zeros(32, dtype=torch.int32, device=device)
        counts = torch.tensor([32.0, 0.0], device=device)
        _, mind, f = ops.assign_fused(
            ones, ones[:32], labels_l, counts, torch.zeros(2, device=device),
            n_clusters=2, kind="linear", precision=precision)
        got = [float(f[:, 0].min()), float(f[:, 0].max()),
               -0.5 * float(mind.max())]
        want, stalled = float(depth), 256.0
    elif kernel in ("embed_assign", "sketch_assign"):
        cents, counts = _probe_cluster_panels(device, 32)
        if kernel == "embed_assign":      # a linear Nystrom map, proj = I
            fmap = NystromMap(landmarks=ones[:32],
                              proj=torch.eye(32, device=device),
                              spec=KernelSpec("linear"))
        else:                             # every column to bucket 0, +1
            fmap = CountSketchMap(
                h=torch.zeros(depth, dtype=torch.int32, device=device),
                sign=torch.ones(depth, device=device), m=32)
        _, score = ops.embed_assign(ones, fmap, cents, counts,
                                    precision=precision)
        got = [float(score.min()), float(score.max())]
        want, stalled = 1.0 - 2.0 * depth, 1.0 - 2.0 * 256
    elif kernel == "flash_attention":
        # 4096 equal scores (q = k = 0) and one unit value: every output is
        # 1/4096, where a bf16 row sum stalls at 256
        q = torch.zeros(1, 1, 16, 16, device=device)
        k = torch.zeros(1, 1, depth, 16, device=device)
        v = torch.zeros(1, 1, depth, 16, device=device)
        v[0, 0, 7, 0] = 1.0
        o = ops.flash_attention(q, k, v, causal=False, precision=precision)
        got = [float(o[..., 0].min()), float(o[..., 0].max())]
        want, stalled = 1.0 / depth, 1.0 / 256
    else:
        raise ValueError(f"no probe for {kernel!r}; have {KERNEL_WRAPPERS}")
    ok = all(abs(g - want) <= 1e-6 * abs(want) for g in got)
    return {"got": got, "want": want, "stalled": stalled, "ok": ok}


def audit_kernel_wrappers(*, n: int, d: int, c: int, device) -> list:
    """(report, violations) per kernel wrapper x tile dtype: the kernel
    (on the CPU its plain version) runs, every accumulation in kernel
    scope is f32, and the f32-accumulation probe passes
    (``report.probe``)."""
    from repro_torch.approx.rff import make_rff
    from repro_torch.approx.sketch import make_count_sketch
    from repro_torch.kernels import ops

    dev = torch.device(device)
    spec = KernelSpec(name="rbf", gamma=0.5)
    x = torch.randn(n, d, generator=_gen()).to(dev)
    landmarks = x[: max(c, 32)]
    m_embed = 64
    rff = make_rff(_gen(1), d, m_embed, spec, device=dev)
    sketch = make_count_sketch(_gen(2), d, m_embed, KernelSpec("linear"),
                               device=dev)
    centroids = torch.randn(c, m_embed, generator=_gen(3)).to(dev)
    counts = torch.ones(c, device=dev)
    labels_l = (torch.arange(landmarks.shape[0], device=dev) % c).to(
        torch.int32)
    g = torch.zeros(c, device=dev)
    qkv = torch.randn(1, 2, 128, 32, generator=_gen(4)).to(dev)

    out = []
    for precision in PRECISIONS:
        wrappers = {
            "kernel_matrix": (lambda x, y: ops.kernel_matrix(
                x, y, kind=spec.name, gamma=spec.gamma, precision=precision),
                (x, landmarks)),
            "assign_fused": (lambda x, lm: ops.assign_fused(
                x, lm, labels_l, counts, g, n_clusters=c, kind=spec.name,
                gamma=spec.gamma, precision=precision), (x, landmarks)),
            "embed_assign": (lambda x: ops.embed_assign(
                x, rff, centroids, counts, precision=precision), (x,)),
            "sketch_assign": (lambda x: ops.embed_assign(
                x, sketch, centroids, counts, precision=precision), (x,)),
            "flash_attention": (lambda q: ops.flash_attention(
                q, q, q, causal=True, precision=precision), (qkv,)),
        }
        for kname, (fn, args) in wrappers.items():
            report = audit(fn, *args, name=f"{kname}[{precision},{dev.type}]")
            violations = report.check_kernel(True, kname)
            violations += report.check_precision()
            report.probe = accumulation_probe(kname, precision, dev)
            if not report.probe["ok"]:
                violations.append(
                    f"{report.name}: f32-accumulation probe gave "
                    f"{report.probe['got']}, want {report.probe['want']} "
                    f"(a bf16 accumulator gives {report.probe['stalled']})")
            out.append((report, violations))
    return out


# ---------------------------------------------------------------------------
# the mesh programs and serving


def make_meshes(device) -> dict:
    """The audit's two meshes over a world of one: (1,) data and (1, 1)
    (data, model); the world must be up."""
    from repro_torch.distributed.mesh import make_test_mesh
    dev = torch.device(device).type
    return {False: make_test_mesh({"data": 1}, device=dev),
            True: make_test_mesh({"data": 1, "model": 1}, device=dev)}


def audit_mesh_path(*, n: int, d: int, n_landmarks: int, c: int,
                    with_model_axis: bool, s_step: int = 1, device,
                    mesh=None) -> tuple:
    """(report, violations) for ``distributed_kkmeans_fit`` on a (1,) or
    (1, 1) mesh: every rank runs the same program whatever the axis
    sizes. ``s_step > 1`` audits the communication-avoiding loop: one
    all_gather + one psum per SYNC, the s-1 local refinements add none."""
    from repro_torch.distributed import inner as dinner

    if mesh is None:
        mesh = make_meshes(device)[with_model_axis]
    spec = KernelSpec(name="rbf", gamma=0.5)
    cfg = dinner.DistributedInnerConfig(
        n_clusters=c, kernel=spec, max_iters=10, engine="materialize",
        col_axis="model" if with_model_axis else None, s_step=s_step)
    x = torch.randn(n, d, generator=_gen()).to(device)
    landmarks = x[:n_landmarks]
    l_idx = torch.arange(n_landmarks, device=x.device)
    u0 = (torch.arange(n, device=x.device) % c).to(torch.int32)
    tag = "data x model" if with_model_axis else "data"
    if s_step > 1:
        tag += f", s={s_step}"
    report = audit(
        lambda *a: dinner.distributed_kkmeans_fit(mesh, *a, cfg=cfg),
        x, landmarks, l_idx, spec.diag(x), u0,
        name=f"distributed_inner[{tag}]")
    bill = dinner.collectives_per_iteration(cfg)
    # one all_gather + one psum per sync, and the prologue sync outside
    # the loop pays the same pair (there is no epilogue)
    violations = report.check_collectives(
        bill, {"psum": bill["psum"], "allgather": bill["allgather"]})
    violations += report.check_host_sync(per_iteration=1)
    if len(report.loops) != 1:
        violations.append(f"{report.name}: expected exactly one inner "
                          f"loop, found {len(report.loops)}")
    return report, violations


def audit_embed_path(*, n: int, d: int, m: int, c: int, device,
                     mesh=None) -> tuple:
    """(report, violations) for the embedded Lloyd mesh program
    (``DistributedEmbedKMeans._shard_lloyd``)."""
    from repro_torch.core.minibatch import MiniBatchConfig
    from repro_torch.distributed import embed as dembed

    if mesh is None:
        mesh = make_meshes(device)[False]
    cfg = MiniBatchConfig(n_clusters=c, n_batches=1,
                          kernel=KernelSpec(name="rbf", gamma=0.5),
                          method="rff", embed_dim=m, max_inner_iters=10)
    km = dembed.DistributedEmbedKMeans(mesh, cfg)
    z = torch.randn(n, m, generator=_gen()).to(device)
    wgt = torch.ones(n, device=z.device)
    labels0 = (torch.arange(n, device=z.device) % c).to(torch.int32)
    report = audit(km._shard_lloyd, z, wgt, labels0, name="embed_lloyd")
    bill = dembed.collectives_per_iteration(c, m)
    violations = report.check_collectives({"psum": bill["psum"]},
                                          {"psum": bill["final_psum"]})
    violations += report.check_host_sync(per_iteration=1)
    return report, violations


def _loop_free(report: ProgramReport, what: str) -> list:
    violations = report.check_host_sync()
    if report.loops:
        violations.append(f"{report.name}: {what} must be loop-free")
    if report.collectives_per_iteration or report.collectives_outside:
        violations.append(f"{report.name}: collectives in {what}")
    return violations


def audit_predict_path(*, n: int, d: int, c: int, device) -> tuple:
    """(report, violations) for serving ``predict``: a pure map, no
    collective, no loop, no host read."""
    from repro_torch.core.minibatch import predict

    spec = KernelSpec(name="rbf", gamma=0.5)
    x = torch.randn(n, d, generator=_gen()).to(device)
    medoids = x[:c]
    report = audit(predict, x, medoids, spec.diag(medoids), spec=spec,
                   device=x.device, name="serving_predict")
    return report, _loop_free(report, "the serving path")


def audit_assign_buckets(*, d: int, c: int, m: int, device,
                         buckets: tuple = (1, 8, 64, 512)) -> list:
    """(report, violations) per shape bucket of a synthetic frozen RFF
    artifact (``serving.artifact.freeze_map``, no fit): each bucket's
    eager program launches embed_assign, accumulates f32, and has no
    loop, collective or host read. Then an ``AssignService`` is warmed on
    the same ladder and must hold one program per bucket."""
    from repro_torch.approx.rff import make_rff
    from repro_torch.serving import assign as sassign
    from repro_torch.serving.artifact import freeze_map

    dev = torch.device(device)
    spec = KernelSpec(name="rbf", gamma=0.5)
    fmap = make_rff(_gen(), d, m, spec, device=dev)
    centroids = torch.randn(c, m, generator=_gen(1)).to(dev)
    art = freeze_map(fmap, centroids, torch.ones(c, device=dev))
    out = []
    for b in buckets:
        xp = torch.zeros(b, d, device=dev)
        report = audit(lambda xq: sassign.run_bucket(art, xq), xp,
                       name=f"serve_bucket[{b}]")
        violations = report.check_kernel(True, "embed_assign")
        violations += report.check_precision()
        violations += _loop_free(report, "the serving bucket program")
        out.append((report, violations))
    svc = sassign.AssignService(art, sassign.AssignServeConfig(
        buckets=tuple(buckets)))
    if svc.compiled_programs != len(set(buckets)):
        out[-1][1].append(
            f"serve_bucket ladder: {svc.compiled_programs} programs != "
            f"ladder size {len(set(buckets))}")
    return out


def run_audits(*, n: int, d: int, n_landmarks: int, c: int, m: int,
               tile_rows: int, device) -> list:
    """The 26 reports; the mesh programs need a world (of one) up."""
    results = audit_engine_modes(n=n, d=d, n_landmarks=n_landmarks, c=c,
                                 tile_rows=tile_rows, device=device)
    results += audit_kernel_wrappers(n=256, d=d, c=c, device=device)
    meshes = make_meshes(device)
    # the s-step variant keeps the per-sync bill on both layouts
    for s_step in (1, 2):
        for two_d in (True, False):
            results.append(audit_mesh_path(
                n=n, d=d, n_landmarks=n_landmarks, c=c,
                with_model_axis=two_d, s_step=s_step, device=device,
                mesh=meshes[two_d]))
    results.append(audit_embed_path(n=n, d=d, m=m, c=c, device=device,
                                    mesh=meshes[False]))
    results.append(audit_predict_path(n=n, d=d, c=c, device=device))
    results += audit_assign_buckets(d=d, c=c, m=m, device=device)
    return results


def summary(report: ProgramReport, violations: list) -> dict:
    """The one-line view of a report: what ``main`` and the card print."""
    return {
        "name": report.name, "status": "FAIL" if violations else "ok",
        "allocator_peak_bytes": report.allocator_peak_bytes,
        "peak_live_bytes": report.peak_live_bytes,
        "largest_intermediate_bytes": report.largest_intermediate_bytes,
        "kernel_launches_per_iteration":
            report.kernel_launches_per_iteration,
        "kernel_launches": report.kernel_launches,
        "plain_calls": report.plain_calls,
        "host_reads_per_iteration": report.host_reads_per_iteration,
        "iterations": [loop.iterations for loop in report.loops],
        "collectives_per_iteration": report.collectives_per_iteration,
        "collectives_outside": report.collectives_outside,
    }


def main(argv=None) -> int:
    from repro_torch.launch.cluster import join_world
    from repro_torch.launch.env import set_device

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.audit",
        description="run every hot path once under the program audit; "
                    "exit 1 on any violated invariant")
    ap.add_argument("--n", type=int, default=512, help="audit batch rows")
    ap.add_argument("--d", type=int, default=16, help="feature dim")
    ap.add_argument("--landmarks", type=int, default=256)
    ap.add_argument("--clusters", type=int, default=8)
    ap.add_argument("--embed-dim", type=int, default=32)
    ap.add_argument("--tile-rows", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    ap.add_argument("--cost", action="store_true",
                    help="attach launch.hlocost's cost terms to every "
                         "report")
    ap.add_argument("--out", default=None,
                    help="write the reports as JSON here")
    args = ap.parse_args(argv)
    if torch.device(args.device or "cuda").type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: the audit runs on the "
                           "GPU by default; pass --device cpu to audit the "
                           "plain PyTorch path")
    dev = set_device(args.device)

    with tempfile.TemporaryDirectory() as tmp:
        started = join_world(dev, tmp)
        try:
            results = run_audits(
                n=args.n, d=args.d, n_landmarks=args.landmarks,
                c=args.clusters, m=args.embed_dim, tile_rows=args.tile_rows,
                device=dev)
        finally:
            if started:
                torch.distributed.destroy_process_group()
    if args.cost:
        from repro_torch.launch.hlocost import cost_terms
        for report, _ in results:
            report.cost = cost_terms(report)

    all_violations = []
    for report, violations in results:
        s = summary(report, violations)
        print(f"[{s['status']}] {report.name}: peak_live="
              f"{report.peak_live_bytes:,}B allocator_peak="
              f"{report.allocator_peak_bytes}B largest="
              f"{report.largest_intermediate_bytes:,}B "
              f"launches/iter={s['kernel_launches_per_iteration'] or '{}'} "
              f"host/iter={s['host_reads_per_iteration']} "
              f"per-iter={report.collectives_per_iteration or '{}'} "
              f"outside={report.collectives_outside or '{}'}")
        for v in violations:
            print(f"       {v}")
        all_violations += violations

    if args.out:
        payload = {"ok": not all_violations, "violations": all_violations,
                   "reports": [r.to_dict() for r, _ in results]}
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=2, default=str)
        print(f"report written to {args.out}")
    if all_violations:
        print(f"{len(all_violations)} violation(s)")
        return 1
    print(f"all {len(results)} program audits clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
