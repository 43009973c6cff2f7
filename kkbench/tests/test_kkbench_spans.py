"""``kkbench/spans.py`` on a hand-built trace (nested spans, idle gaps, a
second thread, ops launched inside and outside spans), and the metrics
that read it on tiny traced runs on the CPU."""
from __future__ import annotations

import types

import pytest

from kkbench import cell as C
from kkbench import run as R
from kkbench import spans, work
from kkbench.trace import WINDOW, Trace

from .tiny import tiny


def _host(name, ts, end, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": end - ts, "tid": tid}


def _op(name, ts, dur, launch, tid, corr, cat="kernel"):
    return [{"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "tid": 7, "args": {"correlation": corr}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": launch, "dur": 0.5, "tid": tid,
             "args": {"correlation": corr}}]


def _trace():
    """Window [0, 100] us on thread 1; busy [5, 15], [22, 32], [38, 39],
    [50, 70], [80, 85]."""
    ev = [_host(WINDOW, 0, 100),
          _host("obs:fit", 10, 90), _host("obs:batch", 12, 60),
          _host("obs:sweep", 20, 40), _host("obs:host_read[changed]", 35, 40),
          _host("obs:merge", 45, 55),
          _host("aten::mm", 21, 23),             # not a span of the program
          _host("obs:stage", 0, 100, tid=2)]     # another thread's
    ev += _op("k1", 5, 10, 4, 1, 1)              # launched in no span
    ev += _op("k2", 22, 10, 21, 1, 2)            # in a sweep
    ev += _op("Memcpy DtoH", 38, 1, 37, 1, 5, cat="gpu_memcpy")
    ev += _op("k3", 50, 20, 46, 1, 3)            # in the merge
    ev += _op("k4", 80, 5, 79, 2, 4)             # from the other thread
    return Trace(ev)


def test_reduce_charges_idle_to_the_innermost_span():
    rows = spans.reduce(_trace())
    assert set(rows) == {"obs:fit", "obs:batch", "obs:sweep",
                         "obs:host_read[changed]", "obs:merge", spans.NONE}
    us = 1e-6
    want = {  # count, self, device, idle, idle while open at any depth
        "obs:fit": (1, 32, 31, 15, 39),
        "obs:batch": (1, 18, 31, 10, 24),
        "obs:sweep": (1, 15, 11, 5, 9),
        "obs:host_read[changed]": (1, 5, 1, 4, 4),
        "obs:merge": (1, 10, 20, 5, 5),
        spans.NONE: (0, 20, 10, 15, 15),
    }
    for name, (count, self_s, device_s, idle_s, idle_in_s) in want.items():
        r = rows[name]
        assert r.count == count, name
        assert r.self_s == pytest.approx(self_s * us), name
        assert r.device_s == pytest.approx(device_s * us), name
        assert r.idle_s == pytest.approx(idle_s * us), name
        assert r.idle_in_s == pytest.approx(idle_in_s * us), name
    t = _trace()
    idle = t.window_s - t.busy_s
    assert sum(r.idle_s for r in spans.reduce(t).values()) == \
        pytest.approx(idle)
    assert sum(r.self_s for r in rows.values()) == pytest.approx(100 * us)
    assert spans.idle_share(t, "obs:sweep") == pytest.approx(9.0)
    assert spans.idle_share(t, "obs:stage") is None


def test_metrics_read_the_spans():
    t = _trace()
    hist = [types.SimpleNamespace(inner_iters=2)]
    ctx = types.SimpleNamespace(
        trace=t, outs=[types.SimpleNamespace(history=hist, rows=[1000])],
        cell={"method": "rff", "embed_dim": 8, "n_clusters": 2,
              "precision": "f32"}, work=work)
    assert R.reader("outer.host_reads_per_sweep")(ctx) == 0.5
    assert R.reader("inner.idle_share")(ctx) == pytest.approx(9.0)
    assert R.reader("stage.idle_share")(ctx) is None
    assert R.reader("device.unspanned_idle_share")(ctx) == pytest.approx(15.0)
    got = R.reader("lloyd.sweep_roofline")(ctx)
    bound = 2 * 4.0 * 1000 * 8 / ctx.work.peak_bytes()
    assert got == pytest.approx(100.0 * bound / 11e-6)


def test_metrics_read_nothing_without_the_programs_spans():
    """A trace of a program that spans nothing (or of the CPU, with no
    device ops): the new metrics give None and do not raise."""
    bare = Trace([_host(WINDOW, 0, 100)] + _op("k1", 5, 10, 4, 1, 1))
    cpu = Trace([_host(WINDOW, 0, 100), _host("obs:fit", 1, 99),
                 _host("obs:sweep", 2, 3)])
    hist = [types.SimpleNamespace(inner_iters=2)]
    for t in (bare, cpu, None):
        ctx = types.SimpleNamespace(
            trace=t, outs=[types.SimpleNamespace(history=hist, rows=[10])],
            cell={"method": "rff", "embed_dim": 8, "n_clusters": 2,
                  "precision": "f32"})
        for m in ("outer.host_reads_per_sweep", "inner.idle_share",
                  "stage.idle_share", "device.unspanned_idle_share",
                  "lloyd.sweep_roofline"):
            assert R.reader(m)(ctx) is None, (m, t)


def _reads_per_fit(cell, out):
    """The host reads the site table gives a fit from its ``BatchStats``:
    a sweep's flag; a batch's cost, displacement (not batch 0's) and
    counts; the mesh's two medoid row reads a batch (one on batch 0); one
    a k-means++ step."""
    b = len(out.history)
    reads = sum(h.inner_iters for h in out.history) + 3 * b - 1
    reads += cell["n_clusters"] - 1
    if cell["entry"] == "mesh":
        reads += 2 * b - 1
    return reads


@pytest.mark.parametrize("name", ["noisy-mnist.exact", "md-traj.exact",
                                  "noisy-mnist.rff"])
def test_traced_run_counts_host_reads_by_the_site_table(name):
    keep = {}
    cell = tiny(name)
    res = R.run(cell, C.benchmark(), seed=2**31 + 5, seconds=0.0,
                trace=True, device="cpu", check_modules=False, keep=keep)
    reads = sum(_reads_per_fit(cell, o) for o in keep["outs"])
    sweeps = sum(h.inner_iters for o in keep["outs"] for h in o.history)
    got = res["metrics"]["outer.host_reads_per_sweep"]
    assert got == {"value": reads / sweeps, "unit": "reads/sweep"}
    # no device ops on the CPU: the device metrics read nothing
    for m in ("inner.idle_share", "stage.idle_share",
              "device.unspanned_idle_share", "lloyd.sweep_roofline"):
        assert m not in res["metrics"]


def test_collective_share_reads_the_nccl_ops():
    """The union of NCCL kernels' intervals inside the window, over the
    window; nothing where no NCCL kernel ran."""
    ev = [_host(WINDOW, 0, 100)]
    ev += _op("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage)",
              10, 20, 9, 1, 1)
    ev += _op("void ncclKernel_AllReduce_RING_LL_Sum_float()", 25, 10, 24,
              1, 2)                              # overlaps the first
    ev += _op("k1", 40, 30, 39, 1, 3)            # compute: not counted
    ev += _op("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage)",
              95, 10, 94, 1, 4)                  # cut at the window's end
    read = R.reader("mesh.collective_share")
    assert read(types.SimpleNamespace(trace=Trace(ev))) == \
        pytest.approx(30.0)
    for t in (_trace(), None):
        assert read(types.SimpleNamespace(trace=t)) is None
