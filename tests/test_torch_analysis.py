"""repro_torch.analysis: the auditor's booby traps, the lint, the launch
audit's contracts, and parity with the reference's static audit.

Case for case the counterpart of ``tests/test_analysis.py``. Every check
must FIRE on an intentionally bad program (a hidden collective in a loop
body, an unbilled collective kind, an oversized intermediate, a fused step
whose kernel never runs, a host read in a loop, iterations that differ, a
plain stand-in that accumulates in bf16) and stay silent on the shipped
hot paths. The parity cases run the reference's ``launch.audit`` (jaxpr,
nothing executed) and the port's (one measured run) at the same shapes:
they must agree on kernel presence per engine mode, the collectives per
iteration and outside the loop, the loop count and the host reads.
"""
import json
import os
import tempfile
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.analysis import (AuditError, LoopReport, ProgramReport,
                                  audit, collective_bill)
from repro_torch.analysis import dispatch
from repro_torch.analysis.dispatch import iteration, loop
from repro_torch.analysis.lint import (Finding, apply_waivers, lint_paths,
                                       load_waivers)
from repro_torch.distributed import mesh as dmesh
from repro_torch.kernels import ops, ref
from repro_torch.launch import audit as launch_audit


@pytest.fixture(scope="module")
def world():
    """A gloo world of one in this process, and its (1,) data mesh."""
    started = not dist.is_initialized()
    with tempfile.TemporaryDirectory() as tmp:
        if started:
            dist.init_process_group(
                "gloo", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                rank=0, world_size=1)
        try:
            yield dmesh.make_test_mesh({"data": 1}, device="cpu")
        finally:
            if started:
                dist.destroy_process_group()


def _psum(mesh, t):
    return dmesh.all_reduce(t, mesh, ("data",))


# ---------------------------------------------------------------------------
# auditor mechanics


def test_audit_counts_ops_and_bytes():
    def f(a, b):
        return a @ b + 1.0

    a, b = torch.ones(8, 4), torch.ones(4, 2)
    r = audit(f, a, b)
    assert r.primitive_counts.get("mm", 0) == 1
    assert r.input_bytes == (32 + 8) * 4
    assert r.output_bytes == 16 * 4
    assert not r.plain_calls and not r.kernel_launches
    assert not r.loops
    assert r.device == "cpu" and r.allocator_peak_bytes is None


def test_audit_liveness_peak_vs_sum():
    """A block that dies before the next is made must not stack with it:
    the peak is one block, not two."""
    def f(x):
        s = torch.sum(torch.outer(x, x))       # [n, n], dies at once
        big2 = torch.outer(x, x)               # a second [n, n]
        big2.mul_(2.0)                         # in place: no third block
        return s + torch.sum(big2)

    x = torch.ones(64)
    r = audit(f, x)
    one_block = 64 * 64 * 4
    assert r.largest_intermediate_bytes == one_block
    assert one_block <= r.peak_live_bytes < 2 * one_block


def test_audit_loop_multiplier(world):
    """A Python loop's collectives: inside ``loop()`` with ticks they are a
    per-iteration bill times the passes; without, all outside."""
    def looped(x):
        with loop("seven"):
            for _ in range(7):
                iteration()
                x = _psum(world, x)
        return x

    def flat(x):
        for _ in range(7):
            x = _psum(world, x)
        return x

    x = torch.ones(3)
    r = audit(looped, x)
    assert len(r.loops) == 1 and r.loops[0].iterations == 7
    assert r.collectives_per_iteration == {"psum": 1}
    assert r.collectives_outside == {}
    assert r.collective_totals(7) == {"psum": 7}
    r2 = audit(flat, x)
    assert not r2.loops and r2.collectives_outside == {"psum": 7}
    # a bill that promised zero psums must be rejected
    violations = r2.check_collectives({}, {"psum": 0})
    assert violations and "psum" in violations[0]


def test_audit_hidden_psum_in_loop_body(world):
    """A loop body smuggling an extra psum breaks the per-iteration bill."""
    def body(x):
        with loop():
            for _ in range(3):
                iteration()
                x = _psum(world, x)                  # billed
                x = x + _psum(world, x * 2)          # smuggled
        return x

    r = audit(body, torch.ones(4))
    assert len(r.loops) == 1
    assert r.collectives_per_iteration == {"psum": 2}
    violations = r.check_collectives({"psum": 1})
    assert violations, "the smuggled psum must be caught"
    with pytest.raises(AuditError):
        r.verify(violations)


def test_audit_unbilled_collective_kind(world):
    """A collective kind the analytic bill has no entry for is flagged."""
    def body(x):
        with loop():
            for _ in range(2):
                iteration()
                x = torch.sum(dmesh.all_gather(x, world, ("data",)))[None]
        return x

    r = audit(body, torch.ones(4))
    violations = r.check_collectives({"psum": 0})
    assert any("unbilled" in v and "all_gather" in v for v in violations)


def test_audit_iterations_that_differ_fire(world):
    """Per-iteration counts are what EVERY iteration issued: an iteration
    with an extra psum is a violation naming both, never an average."""
    def body(x):
        with loop():
            for i in range(3):
                iteration()
                x = _psum(world, x)
                if i == 1:
                    x = _psum(world, x)
        return x

    r = audit(body, torch.ones(2))
    violations = r.check_collectives({"psum": 1})
    assert any("iteration 1" in v and "iteration 0" in v
               for v in violations)


def test_audit_oversized_intermediate_fires():
    """The tiled residency booby trap: materializing the full [n, L] Gram
    block is a failure."""
    n, L = 128, 64

    def bad_tiled_step(x, lm):
        k = torch.exp(-torch.sum((x[:, None, :] - lm[None, :, :]) ** 2, -1))
        return torch.sum(k, dim=1)           # full [n, L] materialized

    r = audit(bad_tiled_step, torch.ones(n, 4), torch.ones(L, 4))
    assert r.largest_intermediate_bytes >= n * L * 4
    violations = r.check_max_intermediate(n * L * 4)
    assert violations
    with pytest.raises(AuditError):
        r.verify(violations)


def test_audit_block_held_in_pieces_fires(monkeypatch):
    """The residency trap no single tensor shows: a tiled or fused fit
    that holds the f32 [rows, |L|] block as four quarters passes
    check_max_intermediate at both dtypes, and the peak-below-the-block
    check fires."""
    from repro_torch.core import kkmeans
    fit = kkmeans.kkmeans_fit

    def hoarding_fit(x, l_idx, diag, labels0, **kw):
        lm = x[l_idx]
        quarters = [torch.cdist(rows, lm) for rows in x.chunk(4)]
        out = fit(x, l_idx, diag, labels0, **kw)
        return out, quarters

    monkeypatch.setattr(kkmeans, "kkmeans_fit", hoarding_fit)
    n, n_l = 256, 256
    for r, violations in launch_audit.audit_engine_modes(
            n=n, d=8, n_landmarks=n_l, c=4, tile_rows=64, device="cpu"):
        if "materialize" in r.name:
            continue
        assert r.largest_intermediate_bytes < n * n_l * 2, r.name
        assert any("the [rows, |L|] block" in v for v in violations), \
            (r.name, violations)


def test_cpu_audit_that_launches_a_kernel_raises():
    """A closure over card tensors audited without card arguments would
    read the CPU's counters: a launch in a CPU audit raises."""
    def launches():
        ops.LAUNCHES["kernel_matrix"] += 1

    try:
        with pytest.raises(AuditError, match="on_device='cuda'"):
            audit(launches)
    finally:
        ops.LAUNCHES["kernel_matrix"] -= 1


def test_audit_kernel_free_fused_step_fires():
    """The PR 5 dead-kernel bug: a 'fused' step in plain PyTorch that never
    reaches the kernel (on the CPU: its plain version) is rejected."""
    def fake_fused(x, lm, h):
        return torch.exp(-((x @ lm.T) ** 2)) @ h   # no kernel

    x, lm, h = torch.ones(32, 4), torch.ones(16, 4), torch.ones(16, 3)
    r = audit(fake_fused, x, lm, h)
    assert not r.plain_calls
    assert r.check_kernel(True, "assign_fused")
    assert r.check_kernel(True)
    # and the converse: a kernel where none was promised
    r2 = audit(lambda *a: ops.gram_matvec(*a, kind="rbf", gamma=1.0),
               x, lm, h)
    assert r2.plain_calls.get("kernel_matrix_ref", 0) >= 1
    assert r2.check_kernel(False)
    assert not r2.check_kernel(True)
    assert r2.kernel_work[0]["work"] == "gram_matvec"


def test_audit_host_read_in_loop_fires():
    def reads(x, per_pass):
        with loop():
            for _ in range(3):
                iteration()
                for _ in range(per_pass):
                    x = x + float(torch.sum(x))
        return x

    x = torch.ones(4)
    r = audit(reads, x, 1)
    assert r.host_callbacks_in_loop == {"_local_scalar_dense": 1}
    assert r.check_host_sync()                       # none allowed
    assert not r.check_host_sync(per_iteration=1)    # the declared flag
    r2 = audit(reads, x, 2)
    assert r2.check_host_sync(per_iteration=1)       # one too many
    # a read outside the loop of a looped program is not a violation ...
    r3 = audit(lambda x: reads(x, 0) + x.sum().item(), x)
    assert r3.host_callbacks == {"_local_scalar_dense": 1}
    assert not r3.check_host_sync()
    # ... but a loop-free program may read nothing
    r4 = audit(lambda x: x + x.sum().item(), x)
    assert r4.check_host_sync(per_iteration=1)


def test_one_hot_range_check_is_no_host_read():
    """F.one_hot reads its input's range on the CPU (not on the card): kept
    apart as a library check, never a host read of the program."""
    def onehots(labels):
        with loop():
            for _ in range(2):
                iteration()
                h = F.one_hot(labels.long(), 4)
        return h

    r = audit(onehots, torch.arange(8) % 4)
    assert r.library_checks > 0
    assert not r.host_callbacks and not r.check_host_sync()


def _bf16_mm_stand_in(x, y, **kw):
    return x.to(torch.bfloat16) @ y.to(torch.bfloat16).T   # bf16 output


def _bf16_accumulating_stand_in(x, y, **kw):
    """K(X, Y) summed column by column in a bf16 accumulator."""
    acc = torch.zeros(x.shape[0], y.shape[0], dtype=torch.bfloat16)
    xb, yb = x.to(torch.bfloat16), y.to(torch.bfloat16)
    for k in range(x.shape[1]):
        acc = acc + xb[:, k:k + 1] * yb[:, k][None, :]
    return acc.float()


def test_precision_trap_bf16_accumulation_fires(monkeypatch):
    """A plain version whose contraction outputs bf16 fails
    check_precision; one that accumulates in bf16 unit steps fails the
    f32-accumulation probe (stalls at 256, not 4096)."""
    x, y = torch.randn(16, 8), torch.randn(4, 8)
    assert not audit(lambda a, b: ops.kernel_matrix(a, b, precision="bf16"),
                     x, y).check_precision()
    monkeypatch.setattr(ref, "kernel_matrix_ref",
                        ref.kernel_scope(_bf16_mm_stand_in))
    r = audit(lambda a, b: ops.kernel_matrix(a, b, precision="bf16"), x, y)
    assert any("mm" in v and "bfloat16" in v for v in r.check_precision())

    # its sums still run in f32 inside the matmul: only the dtype rule
    # catches it, the probe passes
    assert launch_audit.accumulation_probe("kernel_matrix", "bf16",
                                           "cpu")["ok"]
    monkeypatch.setattr(ref, "kernel_matrix_ref",
                        ref.kernel_scope(_bf16_accumulating_stand_in))
    # adds in bf16 are no accumulating op to the dtype rule: the probe
    # catches them
    assert not audit(lambda a, b: ops.kernel_matrix(a, b, precision="bf16"),
                     x, y).check_precision()
    probe = launch_audit.accumulation_probe("kernel_matrix", "bf16", "cpu")
    assert not probe["ok"]
    assert probe["got"][0] == probe["stalled"] == 256.0


def test_probe_passes_on_the_shipped_plain_versions():
    for kernel in launch_audit.KERNEL_WRAPPERS:
        for prec in ("f32", "bf16"):
            probe = launch_audit.accumulation_probe(kernel, prec, "cpu")
            assert probe["ok"], (kernel, prec, probe)


def test_collective_bill_shape(world):
    def body(x):
        with loop():
            for _ in range(2):
                iteration()
                x = _psum(world, x)
        return _psum(world, x)                 # epilogue

    bill = collective_bill(body, torch.ones(1))
    assert bill["per_iteration"] == {"psum": 1}
    assert bill["outside"] == {"psum": 1}
    assert bill["per_iteration_bytes"]["psum"] == 4
    assert bill["outside_bytes"]["psum"] == 4


def test_report_totals_and_json_round_trip():
    r = ProgramReport(name="p")
    r.loops.append(LoopReport(path="loop",
                              collectives={"psum": 3, "all_gather": 1}))
    r.collectives_outside = {"psum": 2}
    assert r.collective_totals(10) == {"psum": 32, "all_gather": 10}
    d = json.loads(json.dumps(r.to_dict()))
    assert d["collectives_per_iteration"] == {"psum": 3, "all_gather": 1}


def test_no_hook_outlives_the_audit():
    """The modes, observers, tallies and loop hooks are gone after audit
    returns or raises; the audited fit gives the labels and plain calls of
    the same fit run bare, and launches nothing on the CPU."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    from repro_torch.core import MiniBatchConfig, fit_dataset
    from repro_torch.data.synthetic import make_blobs

    x, _ = make_blobs(600, 6, 3, sep=6.0, seed=1)
    cfg = MiniBatchConfig(n_clusters=3, n_batches=2, s=0.5, seed=0,
                          engine="fused")

    def fit():
        return fit_dataset(x, cfg, device="cpu").predict(x).numpy()

    launches, calls = dict(ops.LAUNCHES), dict(ref.CALLS)
    plain = fit()
    plain_calls = {k: v - calls.get(k, 0) for k, v in ref.CALLS.items()
                   if v - calls.get(k, 0)}
    r = audit(fit)
    assert np.array_equal(plain, r.output)
    assert r.plain_calls == plain_calls
    assert r.plain_calls.get("assign_fused_ref", 0) > 0
    assert ops.LAUNCHES == launches and r.kernel_launches == {}
    assert np.array_equal(plain, fit())
    with pytest.raises(ZeroDivisionError):
        audit(lambda: 1 / 0)
    assert _get_current_dispatch_mode() is None
    assert not dispatch._OPEN and not ops.WORK_OBSERVERS
    assert not dmesh._TALLIES and ref.DEPTH == 0
    assert dispatch.loop() is dispatch._NULL


# ---------------------------------------------------------------------------
# lint: each rule fires on a fixture, waivers round-trip


def _lint_src(tmp_path, source, fname="mod.py"):
    p = tmp_path / fname
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return lint_paths([str(tmp_path)])


def test_lint_rk001_global_draw(tmp_path):
    findings = _lint_src(tmp_path, """
        import numpy as np
        import torch

        def sampler(n, gen):
            a = torch.randn(n)                       # global generator
            b = torch.rand(n, generator=gen)
            w = torch.empty(n).uniform_()            # global, in place
            rng = np.random.default_rng(0)
            return a + b + w + torch.as_tensor(rng.normal(size=n))
    """)
    rk1 = [f for f in findings if f.rule == "RK001"]
    assert [f.line for f in rk1] == [6, 8]
    assert all(f.symbol == "sampler" for f in rk1)
    assert "torch.randn" in rk1[0].message


def test_lint_rk002_host_read_under_capture(tmp_path):
    findings = _lint_src(tmp_path, """
        import torch

        def leaky(x, statics):
            scale = float(statics["scale"])          # a config value: fine
            return x * scale + x.sum().item()        # a host read

        def clean(x):
            return x * 2

        def capture(graph, x):
            with torch.cuda.graph(graph):
                y = leaky(x, {"scale": 1.0}) + clean(x)
                z = x.cpu()
            return y, z
    """)
    rk2 = [f for f in findings if f.rule == "RK002"]
    assert {(f.symbol, f.line) for f in rk2} == {("leaky", 6),
                                                  ("capture", 14)}


def test_lint_rk003_dead_kernel(tmp_path):
    kernels = tmp_path / "kernels"
    (kernels / "csrc").mkdir(parents=True)
    (kernels / "build.py").write_text(textwrap.dedent("""
        SIGNATURES = {
            "rt_live": [],
            "rt_dead": [],
            "rt_missing": [],
        }
    """))
    (kernels / "csrc" / "a.cu").write_text(textwrap.dedent("""
        extern "C" int rt_live(const void* x) { return 0; }
        extern "C" int rt_dead(const void* x) { return 0; }
        extern "C" int rt_unbound(
            const void* x) { return 0; }
    """))
    (kernels / "wrap.py").write_text(
        '_ENTRY = {"f32": "rt_live"}\nNAMES = ("rt_missing",)\n')
    rk3 = [f for f in lint_paths([str(tmp_path)]) if f.rule == "RK003"]
    got = sorted((f.symbol, "named by no module" in f.message,
                  "no extern" in f.message, "no SIGNATURES" in f.message)
                 for f in rk3)
    assert got == [("rt_dead", True, False, False),
                   ("rt_missing", False, True, False),
                   ("rt_unbound", False, False, True)]


def test_waiver_round_trip(tmp_path):
    f1 = Finding("RK003", "src/kernels/build.py", 7, "rt_dead", "dead")
    f2 = Finding("RK001", "src/x.py", 3, "g", "global draw")
    wpath = tmp_path / "waivers.json"
    wpath.write_text(json.dumps([
        {"rule": "RK003", "path": "kernels/build.py", "symbol": "rt_dead",
         "reason": "bound in the next slice"},
        {"rule": "RK002", "path": "never/hit.py", "reason": "stale"},
    ]))
    waivers = load_waivers(str(wpath))
    active, waived, unused = apply_waivers([f1, f2], waivers)
    assert [f.rule for f in active] == ["RK001"]
    assert [f.rule for f in waived] == ["RK003"]
    assert [w.rule for w in unused] == ["RK002"]
    # a waiver without a reason is rejected outright
    wpath.write_text(json.dumps([{"rule": "RK001", "path": "x.py"}]))
    with pytest.raises(ValueError, match="reason"):
        load_waivers(str(wpath))


def test_lint_cli_green_on_shipped_tree(capsys):
    """The gate: python -m repro_torch.analysis exits 0 with the shipped,
    empty waivers.json, and says once that RK004 has no counterpart."""
    from repro_torch.analysis import lint
    here = os.path.dirname(lint.__file__)
    with open(os.path.join(here, "waivers.json")) as fh:
        assert json.load(fh) == []
    assert lint.main([]) == 0
    out = capsys.readouterr().out
    assert out.count("RK004") == 1 and "lint clean" in out


# ---------------------------------------------------------------------------
# contract tests: the shipped hot paths, engine x mesh


@pytest.mark.parametrize("mode", ["materialize", "fused", "tiled"])
def test_contract_engine_modes(mode):
    results = launch_audit.audit_engine_modes(
        n=256, d=8, n_landmarks=256, c=4, tile_rows=64, device="cpu")
    by_name = {r.name: (r, v) for r, v in results}
    for precision in ("f32", "bf16"):
        r, violations = by_name[f"kkmeans_fit[{mode},{precision}]"]
        assert violations == []
        assert (r.plain_calls.get("assign_fused_ref", 0) > 0) == \
            (mode == "fused")
        assert r.loops and r.loops[0].iterations >= 1
        assert r.host_reads_per_iteration == 1
        if mode == "tiled":
            assert r.largest_intermediate_bytes < 256 * 256 * 4


@pytest.mark.parametrize("s_step", [1, 2])
@pytest.mark.parametrize("with_model_axis", [False, True])
def test_contract_mesh_path(world, with_model_axis, s_step):
    """One all_gather and one psum per sync on both layouts, whatever s,
    and the same pair outside the loop (the prologue sync)."""
    r, violations = launch_audit.audit_mesh_path(
        n=64, d=4, n_landmarks=16, c=4, with_model_axis=with_model_axis,
        s_step=s_step, device="cpu")
    assert violations == []
    assert r.collectives_per_iteration == {"psum": 1, "all_gather": 1}
    assert r.collectives_outside == {"psum": 1, "all_gather": 1}


def test_sstep_sync_is_single_collective_pair(world):
    """The trap form: audit the mesh program directly; a bill promising
    anything but 1 psum + 1 all_gather per sync is rejected."""
    from repro_torch.core.kernels import KernelSpec
    from repro_torch.distributed import inner as dinner

    spec = KernelSpec(name="rbf", gamma=0.5)
    mesh = dmesh.make_test_mesh({"data": 1, "model": 1}, device="cpu")
    cfg = dinner.DistributedInnerConfig(
        n_clusters=4, kernel=spec, max_iters=5, engine="materialize",
        col_axis="model", s_step=2)
    x = torch.randn(64, 4, generator=torch.Generator().manual_seed(0))
    r = audit(lambda *a: dinner.distributed_kkmeans_fit(mesh, *a, cfg=cfg),
              x, x[:16], torch.arange(16), spec.diag(x),
              (torch.arange(64) % 4).to(torch.int32), name="sstep_trap")
    assert r.collectives_per_iteration == {"psum": 1, "all_gather": 1}
    assert r.check_collectives({"psum": 0, "allgather": 1})
    assert r.check_collectives({"psum": 2, "allgather": 1})
    assert r.check_collectives({"psum": 1, "allgather": 0})
    assert not r.check_collectives({"psum": 1, "allgather": 1},
                                   {"psum": 1, "allgather": 1})


def test_contract_embed_and_predict(world):
    r, violations = launch_audit.audit_embed_path(n=64, d=4, m=16, c=4,
                                                  device="cpu")
    assert violations == []
    # one fused psum per Lloyd sweep, one identical prologue sync outside
    assert r.collectives_per_iteration == {"psum": 1}
    assert r.collectives_outside == {"psum": 1}
    r2, violations2 = launch_audit.audit_predict_path(n=64, d=4, c=4,
                                                      device="cpu")
    assert violations2 == []
    assert not r2.loops and not r2.host_callbacks


def test_audit_cli_smoke(world, tmp_path):
    """The CLI over every path on the CPU, report artifact written."""
    out = tmp_path / "report.json"
    assert launch_audit.main(["--n", "256", "--d", "8", "--landmarks", "256",
                              "--clusters", "4", "--tile-rows", "64",
                              "--device", "cpu", "--cost",
                              "--out", str(out)]) == 0
    payload = json.loads(out.read_text())
    assert payload["ok"] and not payload["violations"]
    # 3 engine modes x 2 precisions + 5 kernel wrappers x 2 precisions
    # + 4 mesh programs + embedded Lloyd + serving predict
    # + 4 serving shape-bucket programs
    assert len(payload["reports"]) == 26
    names = {r["name"] for r in payload["reports"]}
    assert "kkmeans_fit[fused,f32]" in names
    assert "kkmeans_fit[fused,bf16]" in names
    assert "assign_fused[bf16,cpu]" in names
    assert "serving_predict" in names
    assert "distributed_inner[data, s=2]" in names
    assert "distributed_inner[data x model, s=2]" in names
    # --cost prices every report from its own run
    assert all(r["cost"] for r in payload["reports"])
    engine = [r for r in payload["reports"]
              if r["name"].startswith("kkmeans_fit[")]
    assert len(engine) == 6 and all(r["cost"]["flops"] > 0 for r in engine)
    wrapper = next(r for r in payload["reports"]
                   if r["name"] == "assign_fused[f32,cpu]")
    assert [i["kernel"] for i in wrapper["cost"]["kernel_work"]] == \
        ["assign_fused"]


def test_audit_cli_without_a_card_names_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            launch_audit.main(argv)


# ---------------------------------------------------------------------------
# parity with the reference's static audit


@pytest.fixture(scope="module")
def jax_audit():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platform_name", "cpu")
    from repro.launch import audit as ref_audit
    return ref_audit


def test_parity_engine_modes(jax_audit):
    shapes = dict(n=256, d=8, n_landmarks=256, c=4, tile_rows=64)
    theirs = {r.name: (r, v) for r, v in jax_audit.audit_engine_modes(
        interpret=True, with_hlo=False, **shapes)}
    ours = {r.name: (r, v) for r, v in launch_audit.audit_engine_modes(
        device="cpu", **shapes)}
    assert set(theirs) == set(ours) and len(ours) == 6
    for name, (t, tv) in theirs.items():
        o, ov = ours[name]
        assert tv == [] and ov == []
        assert (t.pallas_calls > 0) == \
            (o.plain_calls.get("assign_fused_ref", 0) > 0), name
        assert len(t.loops) == len(o.loops) == 1
        assert t.collectives_per_iteration == o.collectives_per_iteration \
            == {}
        assert t.collectives_outside == o.collectives_outside == {}
        # host reads: none in the reference's loop, the one declared flag
        # read per iteration in the port's
        assert t.host_callbacks_in_loop == {}
        assert not o.check_host_sync(per_iteration=1)


@pytest.mark.parametrize("s_step", [1, 2])
@pytest.mark.parametrize("with_model_axis", [False, True])
def test_parity_mesh_path(world, jax_audit, with_model_axis, s_step):
    kw = dict(n=64, d=4, n_landmarks=16, c=4,
              with_model_axis=with_model_axis, s_step=s_step)
    t, tv = jax_audit.audit_mesh_path(**kw)
    o, ov = launch_audit.audit_mesh_path(device="cpu", **kw)
    assert t.name == o.name and tv == [] and ov == []
    assert t.collectives_per_iteration == o.collectives_per_iteration
    assert t.collectives_outside == o.collectives_outside
    # the payloads too: labels (with the bit-packed scalars on 2-D) and
    # the flat stats buffer, per rank
    assert t.collective_bytes_per_iteration == \
        o.collective_bytes_per_iteration
    assert len(t.loops) == len(o.loops) == 1
    assert t.host_callbacks_in_loop == {}
    assert o.host_reads_per_iteration <= 1


def test_parity_embed_path(world, jax_audit):
    t, tv = jax_audit.audit_embed_path(n=64, d=4, m=16, c=4)
    o, ov = launch_audit.audit_embed_path(n=64, d=4, m=16, c=4,
                                          device="cpu")
    assert tv == [] and ov == []
    assert t.collectives_per_iteration == o.collectives_per_iteration
    assert t.collectives_outside == o.collectives_outside
    # the port sums its embedded payload (C*(m+1) + 2 values) in f64, the
    # reference in f32: twice the bytes (ROADMAP Queue 3)
    assert o.collective_bytes_per_iteration["psum"] == \
        2 * t.collective_bytes_per_iteration["psum"] == 8 * (4 * 17 + 2)
    assert len(t.loops) == len(o.loops) == 1
    assert o.host_reads_per_iteration <= 1


def test_parity_predict_path(jax_audit):
    t, tv = jax_audit.audit_predict_path(n=64, d=4, c=4)
    o, ov = launch_audit.audit_predict_path(n=64, d=4, c=4, device="cpu")
    assert tv == [] and ov == []
    assert not t.loops and not o.loops
    assert not t.host_callbacks and not o.host_callbacks
    assert not (t.collectives_outside or o.collectives_outside)
