"""The port's layer spans (``repro_torch.obs.span``) inside its fits, on the
CPU profiler: each entry (the single-device exact fit, the mesh on a gloo
world of one, the RFF fit) gives one ``obs:fit``, one ``obs:batch`` a
batch, one ``obs:sweep`` and one ``obs:host_read[changed]`` a sweep, each
span inside the parent ``repro_torch/obs/trace.py`` names; every read of a
tensor value by the host lies in an ``obs:host_read`` span, one read a
span; and fits, ``history`` and ``predict`` are bitwise the same with the
profiler on and off."""
import collections
import contextlib
import json
import os

import pytest
import torch

from repro_torch import obs
from repro_torch.core import KernelSpec, MiniBatchConfig, fit_dataset
from repro_torch.data.synthetic import make_blobs
from repro_torch.kernels import ref

C = 4
ENTRIES = ["exact", "mesh", "rff"]

#: the spans a span may nest in (None: none)
PARENTS = {
    "obs:fit": {None},
    "obs:predict": {None},
    "obs:batch": {"obs:fit"},
    "obs:stage": {"obs:batch", "obs:fit"},
    "obs:embed_phi": {"obs:batch", "obs:fit"},
    "obs:landmarks": {"obs:batch"},
    "obs:kmeanspp": {"obs:batch"},
    "obs:eq8": {"obs:batch", "obs:predict"},
    "obs:gram_panel_build": {"obs:batch"},
    "obs:sweep": {"obs:batch"},
    "obs:engine_stats[materialize]": {"obs:sweep", "obs:batch"},
    "obs:g_from_rows": {"obs:engine_stats[materialize]"},
    "obs:allgather_u": {"obs:sweep", "obs:batch"},
    "obs:psum_fused": {"obs:sweep", "obs:batch"},
    "obs:merge": {"obs:batch"},
    "obs:host_read[changed]": {"obs:sweep"},
    "obs:host_read[batch_stats]": {"obs:batch"},
    "obs:host_read[merge_rows]": {"obs:merge"},
    "obs:host_read[kmeanspp]": {"obs:kmeanspp"},
}


@contextlib.contextmanager
def _world(tmp_path):
    """A gloo world of one for the mesh entry (none other is up here)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _run(entry, tmp_path):
    """One fit of ``entry`` and ``predict`` on its rows -> (FitResult,
    labels)."""
    x, _ = make_blobs(600, 8, C, sep=6.0, seed=3)
    spec = KernelSpec("rbf", gamma=0.5)
    if entry == "rff":
        cfg = MiniBatchConfig(n_clusters=C, n_batches=2, kernel=spec,
                              seed=1, method="rff", embed_dim=16)
        res = fit_dataset(x, cfg, device="cpu")
        return res, res.predict(x)
    cfg = MiniBatchConfig(n_clusters=C, n_batches=3, s=0.5, kernel=spec,
                          seed=1, engine="materialize")
    if entry == "exact":
        res = fit_dataset(x, cfg, device="cpu")
        return res, res.predict(x)
    from repro_torch.distributed import (DistributedMiniBatchKMeans,
                                         make_test_mesh)
    with _world(tmp_path):
        mesh = make_test_mesh({"data": 1}, device="cpu")
        res = DistributedMiniBatchKMeans(mesh, cfg).fit(
            [x[i::3] for i in range(3)])
    return res, res.predict(x)


def _profiled(fn, path):
    """``fn()`` under the CPU profiler -> (its result, the events of the
    thread that ran its ``obs:fit``: [(name, start, end)] of the ``obs:``
    spans and of the aten ops, each by start)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    os.remove(path)
    tid = next(e["tid"] for e in events if e["name"] == "obs:fit")

    def pick(keep):
        got = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in events if e["tid"] == tid and keep(e)]
        return sorted(got, key=lambda s: (s[1], -s[2]))

    return out, pick(lambda e: e["name"].startswith("obs:")), pick(
        lambda e: e.get("cat") == "cpu_op")


def _parents(spans):
    """The innermost span each span lies in (None: none), in order."""
    out, stack = [], []
    for name, a, b in spans:
        while stack and stack[-1][2] <= a:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
        stack.append((name, a, b))
    return out


def _inside(t, spans, prefix):
    """The innermost of ``spans`` whose name starts with ``prefix`` and
    that holds instant ``t`` (None: none)."""
    got = [s for s in spans if s[0].startswith(prefix) and s[1] <= t <= s[2]]
    return max(got, key=lambda s: s[1])[0] if got else None


@pytest.mark.parametrize("entry", ENTRIES)
def test_fit_spans_count_and_nest(entry, tmp_path):
    (res, _), spans, _ = _profiled(lambda: _run(entry, tmp_path),
                                   tmp_path / "t.json")
    parents = _parents(spans)
    for (name, _, _), parent in zip(spans, parents):
        assert parent in PARENTS[name], (name, parent)
    n = collections.Counter(s[0] for s in spans)
    in_fit = collections.Counter(s[0] for s, p in zip(spans, parents)
                                 if p != "obs:predict")
    b = len(res.history)
    iters = sum(h.inner_iters for h in res.history)
    assert b > 1 and iters > b
    assert n["obs:fit"] == 1 and n["obs:predict"] == 1
    assert n["obs:batch"] == b and in_fit["obs:eq8"] == b
    assert n["obs:sweep"] == n["obs:host_read[changed]"] == iters
    # g from f's landmark rows in every stats pass of the exact fits
    assert (n["obs:g_from_rows"] == n["obs:engine_stats[materialize]"]
            == (0 if entry == "rff" else iters + b))
    assert n["obs:kmeanspp"] == 1 and n["obs:host_read[kmeanspp]"] == C - 1
    assert n["obs:host_read[batch_stats]"] == 3 * b - 1
    if entry == "rff":
        assert n["obs:merge"] == b - 1 and n["obs:landmarks"] == 0
        assert n["obs:embed_phi"] == b + 1
    else:
        assert n["obs:merge"] == n["obs:landmarks"] == b
    assert n["obs:host_read[merge_rows]"] == (2 * b - 1 if entry == "mesh"
                                              else 0)
    assert n["obs:stage"] >= b + 1


@pytest.mark.parametrize("entry", ENTRIES)
def test_every_read_lies_in_a_host_read_span(entry, tmp_path):
    """Every host read of a tensor value (``aten::_local_scalar_dense``) on
    the fit's thread lies in an ``obs:host_read`` span, at most one a
    span. Apart: ``F.one_hot``'s range check, which reads on the CPU only,
    and k-means++'s first draw from its CPU generator (one a seeding,
    never on the device)."""
    _, spans, ops = _profiled(lambda: _run(entry, tmp_path),
                              tmp_path / "t.json")
    reads = [op for op in ops if op[0] == "aten::_local_scalar_dense"
             and _inside(op[1], ops, "aten::one_hot") is None]
    per_span = collections.Counter()
    outside = []
    for _, t, _ in reads:
        where = _inside(t, spans, "obs:")
        if where is not None and where.startswith("obs:host_read["):
            per_span[next(s for s in reversed(spans)
                          if s[0] == where and s[1] <= t)[1]] += 1
        else:
            outside.append(where)
    n = collections.Counter(s[0] for s in spans)
    assert outside == ["obs:kmeanspp"] * n["obs:kmeanspp"]
    assert per_span and max(per_span.values()) == 1
    assert sum(per_span.values()) >= n["obs:host_read[changed]"]


def _host(res, labels):
    st = res.state
    tensors = [t for t in st if torch.is_tensor(t)] + [labels]
    if res.fmap is not None:
        tensors += [res.fmap.w, res.fmap.b]
    hist = [(h.inner_iters, h.cost, h.displacement.tobytes(),
             h.counts.tobytes()) for h in res.history]
    return [t.numpy().tobytes() for t in tensors], hist


def _counted(fn):
    """``fn()`` -> (its result, the plain kernel versions it called)."""
    before = dict(ref.CALLS)
    out = fn()
    return out, {k: v - before.get(k, 0) for k, v in ref.CALLS.items()}


@pytest.mark.parametrize("entry", ENTRIES)
def test_fits_equal_with_the_profiler_on_and_off(entry, tmp_path):
    """The spans change no bit and no kernel call."""
    off, calls_off = _counted(lambda: _run(entry, tmp_path))
    ((res, labels), calls_on), spans, _ = _profiled(
        lambda: _counted(lambda: _run(entry, tmp_path)), tmp_path / "t.json")
    assert spans
    assert _host(res, labels) == _host(*off)
    assert calls_on == calls_off and sum(calls_on.values()) > 0


def test_span_is_one_shared_null_context_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    assert obs.span("obs:sweep") is obs.span("obs:host_read[changed]")
    with obs.span("obs:sweep") as got:
        assert got is None


def test_batch_spans_number_and_fetch_inside_each_batch(tmp_path):
    """``batch_spans`` numbers from ``start``, fetches every batch (and the
    end of the iterable) inside an ``obs:batch`` under ``obs:stage``, and
    opens one ``obs:batch`` a batch."""
    fetched = []

    def source():
        for k in range(3):
            with obs.span("obs:fetched"):
                fetched.append(k)
            yield k

    def loop():
        with obs.span("obs:fit"):
            return list(obs.batch_spans(source(), start=5))

    got, spans, _ = _profiled(loop, tmp_path / "t.json")
    assert got == [(5, 0), (6, 1), (7, 2)] and fetched == [0, 1, 2]
    n = collections.Counter(s[0] for s in spans)
    assert n["obs:batch"] == 3 and n["obs:stage"] == 4
    parents = dict(zip(spans, _parents(spans)))
    assert all(parents[s] == "obs:stage" for s in spans
               if s[0] == "obs:fetched")
    assert list(obs.batch_spans([])) == []
