"""The port's flight recorder (``repro_torch.obs``), its straggler monitor
and the recorder hooks, against the reference's (``repro.obs``,
``repro.ft.straggler``) on the same numpy inputs.

Case for case these are ``tests/test_obs.py``'s contracts: the Null
contract; the JSONL round trip, the tensor drain and thread safety; the CPU
watermark fallback; fits that give the same bits, the same kernel launches
(``ops.LAUNCHES``) and plain calls (``ref.CALLS``) with the recorder on as
off, with one wall time and one watermark a batch and the drained costs
equal to the history; the mesh fits' measured collective bill equal to the
analytic one (``collectives_per_iteration`` x (syncs + the prologue)) at
worlds 1 and 2 over gloo (world 2 in spawned ranks); the streaming mesh
fit's ``prefetch/*`` series from the producer thread; the elastic events;
the service's ``serve/*`` records at an unchanged program count; and the
launchers' ``--obs`` logs and ``--profile`` traces. Against the reference:
``summarize`` folds either package's log alike, ``replan_rows`` and
``detect_stragglers`` agree under hypothesis (the strategies of
``tests/test_property.py``), ``StragglerMonitor`` emits the same events,
and every instrumented path writes records of the reference's names,
kinds and fields (``_signature``).
"""
import datetime
import json
import os
import pickle
import threading
import time
import traceback

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
from repro import obs as jobs
from repro.core import KernelSpec as JSpec
from repro.core import MiniBatchConfig as JConfig
from repro.core.minibatch import fit_dataset as j_fit_dataset
from repro.ft import straggler as jstrag
from repro_torch import obs
from repro_torch.core import KernelSpec, MiniBatchConfig, fit, fit_dataset
from repro_torch.data.synthetic import make_blobs
from repro_torch.ft import straggler
from repro_torch.kernels import ops, ref
from repro_torch.obs import (NULL, JsonlRecorder, MetricsRecorder,
                             NullRecorder, export, resolve)

DEADLINE = 120.0
#: per-record fields whose values are measurements, not structure
_VALUES = {"t"}


def _events(path, kind=None, name=None):
    out = export.read_events(path)
    if kind is not None:
        out = [e for e in out if e.get("kind") == kind]
    if name is not None:
        out = [e for e in out if e.get("name") == name]
    return out


def _signature(path) -> set:
    """{(kind, name, field names)} of a log's records, the header aside:
    what must be alike between the packages."""
    return {(e["kind"], e.get("name"), tuple(sorted(set(e) - _VALUES)))
            for e in export.read_events(path) if e["kind"] != "header"}


def _zero():
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    for k in ref.CALLS:
        ref.CALLS[k] = 0


def _spec():
    return KernelSpec("rbf", gamma=0.5)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def test_null_recorder_contract():
    """NULL is the default: disabled, every hook a no-op, resolve(None)
    hands it back."""
    assert resolve(None) is NULL
    assert isinstance(NULL, NullRecorder)
    assert NULL.enabled is False
    r = resolve(NULL)
    r.counter("c", 3, batch=0)
    r.gauge("g", 1.0)
    r.series("s", torch.tensor(1.0))
    r.event("e", detail="x")
    with r.timer("t"):
        pass
    r.batch_boundary(0)
    r.close()
    mine = JsonlRecorder.__new__(JsonlRecorder)
    assert resolve(mine) is mine


def test_jsonl_recorder_roundtrip(tmp_path):
    path = str(tmp_path / "log.jsonl")
    rec = JsonlRecorder(path, header=export.run_header(device="cpu",
                                                       case="unit"))
    assert rec.enabled is True
    rec.counter("collectives/psum", 5, batch=0)
    rec.counter("collectives/psum", 7, batch=1)
    rec.gauge("queue", 2, batch=0)
    rec.series("wall", 0.25, batch=0)
    rec.series("cost", torch.tensor(3.5), batch=0)   # parked tensor
    with rec.timer("stage") as t:
        pass
    rec.event("hbm_watermark", batch=0, source="host_rss",
              measured_bytes=100, peak_bytes=100, predicted_bytes=80.0,
              tensor_field=torch.arange(3))
    rec.batch_boundary(0)
    rec.close()

    (header,) = _events(path, kind="header")
    assert header["backend"] == "cpu" and header["case"] == "unit"
    assert header["torch"] == torch.__version__
    assert header["n_processes"] == 1 and header["n_devices"] == 1
    assert _events(path, kind="counter")[-1]["total"] == 12
    (cost,) = _events(path, kind="series", name="cost")
    assert cost["value"] == pytest.approx(3.5)
    assert t.seconds >= 0.0
    (mark,) = _events(path, kind="event", name="hbm_watermark")
    assert mark["tensor_field"] == [0, 1, 2]          # _jsonable
    with open(path) as f:
        for line in f:
            json.loads(line)
    s = export.summarize(path)
    assert s["events"] == len(export.read_events(path))
    assert s["counters"]["collectives/psum"] == 12
    assert s["stats"]["wall"]["count"] == 1
    assert s["last_watermark"]["predicted_bytes"] == 80.0


def test_drain_reads_mixed_tensors_without_item(tmp_path, monkeypatch):
    """Parked tensors of several dtypes drain to the right floats in one
    stacked read, never through ``.item()``; nothing is written before
    the boundary."""
    def no_item(self):
        raise AssertionError("the drain called .item()")
    monkeypatch.setattr(torch.Tensor, "item", no_item)
    path = str(tmp_path / "drain.jsonl")
    rec = JsonlRecorder(path)
    vals = [torch.tensor(2.5), torch.tensor(7, dtype=torch.int64),
            torch.tensor(True), torch.tensor(1.25, dtype=torch.float64),
            torch.tensor([3], dtype=torch.int32)]
    for k, v in enumerate(vals):
        rec.series(f"s{k}", v, batch=0)
    assert _events(path) == []
    rec.batch_boundary(0)
    got = [e["value"] for e in _events(path, kind="series")]
    assert got == [2.5, 7.0, 1.0, 1.25, 3.0]
    rec.close()
    assert [e["batch"] for e in _events(path, kind="boundary")] == [0, -1]


def test_jsonl_recorder_thread_safety(tmp_path):
    """Producer-thread writes interleave with the consumer's drains
    without losing or tearing a record (the PrefetchLoader contract)."""
    path = str(tmp_path / "mt.jsonl")
    rec = JsonlRecorder(path)

    def hammer(tid):
        for k in range(200):
            rec.counter("n", 1, thread=tid)
            rec.series(f"s{tid}", torch.tensor(float(k)))
            if k % 50 == 0:
                rec.batch_boundary(k)

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rec.close()
    assert rec.totals["n"] == 800
    assert len(_events(path, kind="counter", name="n")) == 800
    for tid in range(4):
        got = sorted(e["value"] for e in
                     _events(path, kind="series", name=f"s{tid}"))
        assert got == [float(k) for k in range(200)]


def test_memory_watermark_cpu_fallback():
    """On the CPU the watermark still measures, tagged host_rss, beside
    the predicted bytes; the card's stats are never read for a CPU fit."""
    from repro_torch.obs import memory as obs_memory

    class Sink(MetricsRecorder):
        enabled = True

        def __init__(self):
            self.events = []

        def event(self, name, **fields):
            self.events.append((name, fields))

    sink = Sink()
    obs_memory.watermark(sink, batch=0, predicted_bytes=123.0, device="cpu")
    obs_memory.watermark(NULL, batch=0, predicted_bytes=1.0, device="cpu")
    (name, fields), = sink.events
    assert name == "hbm_watermark"
    assert fields["predicted_bytes"] == 123.0
    assert fields["source"] == "host_rss" and fields["devices"] == []
    assert fields["measured_bytes"] > 0
    assert obs_memory.device_memory_stats("cpu") == []


@pytest.mark.parametrize("method", ["exact", "rff", "sketch"])
def test_predicted_footprints_equal_the_references(method):
    from repro.obs import memory as jmem
    from repro_torch.obs import memory as tmem
    kw = dict(n_clusters=6, n_batches=3, s=0.5, method=method,
              embed_dim=0 if method == "exact" else 24,
              engine="fused" if method == "exact" else "materialize")
    got = tmem.predicted_batch_footprint(MiniBatchConfig(**kw), 300, 17,
                                         n_devices=2, density=0.3)
    want = jmem.predicted_batch_footprint(JConfig(**kw), 300, 17,
                                          n_devices=2, density=0.3)
    assert got == want


def test_summarize_equal_between_packages(tmp_path):
    """Either package's summarize folds either package's log alike."""
    logs = []
    for pkg, rec_cls, value in (("torch", JsonlRecorder, torch.tensor),
                                ("jax", jobs.JsonlRecorder, jnp.float32)):
        path = str(tmp_path / f"{pkg}.jsonl")
        rec = rec_cls(path)
        for b in range(3):
            rec.counter("collectives/psum", 2 + b, batch=b)
            rec.series("inner/cost", value(1.5 * b), batch=b)
            rec.series("batch/wall_seconds", 0.1 * (b + 1), batch=b)
            rec.gauge("clusters/empty", b, batch=b)
            with rec.timer("stage/seconds"):
                pass
            rec.event("hbm_watermark", batch=b, source="host_rss",
                      measured_bytes=10 * b, peak_bytes=20 * b,
                      predicted_bytes=5.0 * b)
            rec.batch_boundary(b)
        rec.close()
        logs.append(path)
    for path in logs:
        assert export.summarize(path) == jobs.export.summarize(path)
    ta, tb = export.summarize(logs[0]), export.summarize(logs[1])
    for k in ("counters", "last_watermark", "events"):
        assert ta[k] == tb[k]
    assert ta["stats"]["stage/seconds"]["count"] == 3
    for k in ("inner/cost", "batch/wall_seconds", "clusters/empty"):
        assert ta["stats"][k] == tb["stats"][k]


def test_run_header_names_the_device():
    h = export.run_header(device="cpu", plan={"b": 4}, entry="x")
    assert h["kind"] == "header" and h["backend"] == "cpu"
    assert h["entry"] == "x" and h["plan"] == {"b": 4}
    assert {"commit", "torch", "device_kind", "n_devices",
            "n_processes"} <= set(h)


def test_profile_is_idempotent_and_names_spans(tmp_path):
    from repro_torch.obs import span, start_profile, stop_profile
    assert stop_profile() is None
    start_profile(str(tmp_path / "p"))
    start_profile(str(tmp_path / "q"))          # keeps the first window
    with span("obs:unit_span"):
        torch.ones(4).sum()
    with span("obs:unit_host"):                 # host work alone
        pass
    assert stop_profile() == str(tmp_path / "p")
    with open(tmp_path / "p" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"obs:unit_span", "obs:unit_host"} <= names
    assert not (tmp_path / "q").exists()


# ---------------------------------------------------------------------------
# the straggler monitor, against the reference's
# ---------------------------------------------------------------------------


@given(st.integers(1, 64), st.integers(0, 63),
       st.lists(st.floats(0.1, 100.0), min_size=1, max_size=16),
       st.integers(0, 3))
@settings(max_examples=60, deadline=None)
def test_replan_rows_equals_the_references(nq, extra, speeds, n_dead):
    n_rows = nq * 8 + extra
    plans = []
    for mod in (straggler, jstrag):
        statuses = [mod.WorkerStatus(i, rows_per_second=s)
                    for i, s in enumerate(speeds)]
        for i in range(min(n_dead, len(statuses) - 1)):
            statuses[i] = mod.WorkerStatus(i, healthy=False)
        plans.append(mod.replan_rows(n_rows, statuses))
    assert plans[0] == plans[1]
    cursor = 0
    for start, size in sorted(plans[0].values()):
        assert start == cursor and size >= 0
        cursor += size
    assert cursor == n_rows


@given(st.lists(st.floats(0.1, 100.0), min_size=0, max_size=16),
       st.floats(1.0, 3.0))
@settings(max_examples=60, deadline=None)
def test_detect_stragglers_equals_the_references(times, threshold):
    timings = dict(enumerate(times))
    assert (straggler.detect_stragglers(timings, threshold=threshold)
            == jstrag.detect_stragglers(timings, threshold=threshold))


def test_straggler_monitor_events_equal_the_references(tmp_path):
    assert straggler.detect_stragglers({}) == []
    assert straggler.detect_stragglers({0: 1.0, 1: 1.1, 2: 1.0}) == []
    assert straggler.detect_stragglers({0: 1.0, 1: 1.1, 2: 5.0}) == [2]
    rounds = [({0: 1.0, 1: 1.05, 2: 0.95}, 1200),
              ({0: 1.0, 1: 1.0, 2: 4.0}, 1200),
              ({0: 0.5, 1: 2.5, 2: 0.6}, 1000),
              ({0: 4.0, 1: 1.0}, None)]
    logs, flagged = [], []
    for name, mod, rec_cls in (("torch", straggler, JsonlRecorder),
                               ("jax", jstrag, jobs.JsonlRecorder)):
        path = str(tmp_path / f"{name}.jsonl")
        rec = rec_cls(path)
        mon = mod.StragglerMonitor(rec, threshold=1.5)
        flagged.append([mon.observe(b, t, n_rows=n)
                        for b, (t, n) in enumerate(rounds)])
        rec.close()
        logs.append([{k: v for k, v in e.items() if k != "t"}
                     for e in _events(path, kind="event")])
    assert flagged[0] == flagged[1] == [[], [2], [1], [0]]
    assert logs[0] == logs[1]
    det = [e for e in logs[0] if e["name"] == "straggler_detected"]
    sizes = {k: v[1] for k, v in det[0]["replan"].items()}
    assert sizes["2"] == min(sizes.values())
    assert straggler.WorkerStatus(3).healthy


# ---------------------------------------------------------------------------
# the single-host fits
# ---------------------------------------------------------------------------


def _fit_on_off(tmp_path, run):
    """``run(recorder)`` with NULL and with a JsonlRecorder -> (result off,
    result on, log path, launches and plain calls of each)."""
    _zero()
    off = run(None)
    counts_off = (dict(ops.LAUNCHES), dict(ref.CALLS))
    path = str(tmp_path / "on.jsonl")
    _zero()
    with JsonlRecorder(path, header=export.run_header(device="cpu")) as rec:
        on = run(rec)
    counts_on = (dict(ops.LAUNCHES), dict(ref.CALLS))
    return off, on, path, counts_off, counts_on


def _same_state(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a[:-1], b[:-1]))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("engine", ["materialize", "fused", "tiled"])
def test_recorder_is_neutral_exact(tmp_path, engine, precision):
    x, _ = make_blobs(160, 8, 4, sep=6.0, seed=0)
    cfg = MiniBatchConfig(n_clusters=4, n_batches=2, s=1.0, kernel=_spec(),
                          seed=0, engine=engine, precision=precision)
    off, on, path, c_off, c_on = _fit_on_off(
        tmp_path, lambda r: fit_dataset(x, cfg, device="cpu", recorder=r))
    assert _same_state(off.state, on.state)
    assert [h.cost for h in off.history] == [h.cost for h in on.history]
    assert c_off == c_on
    walls = _events(path, kind="series", name="batch/wall_seconds")
    assert len(walls) == cfg.n_batches and all(w["value"] > 0 for w in walls)
    costs = _events(path, kind="series", name="inner/cost")
    assert [c["value"] for c in costs] == pytest.approx(
        [h.cost for h in on.history])
    iters = _events(path, kind="series", name="inner/iters")
    assert [i["value"] for i in iters] == [h.inner_iters
                                           for h in on.history]
    marks = _events(path, kind="event", name="hbm_watermark")
    assert len(marks) == cfg.n_batches
    for m in marks:
        assert m["measured_bytes"] > 0 and m["predicted_bytes"] > 0
        assert m["source"] == "host_rss" and m["engine"] == engine
    assert len(_events(path, kind="gauge", name="clusters/empty")) == 2
    assert len(_events(path, kind="boundary")) == cfg.n_batches + 1


@pytest.mark.parametrize("method", ["rff", "nystrom", "sketch",
                                    "tensorsketch"])
def test_recorder_is_neutral_embedded(tmp_path, method):
    x, _ = make_blobs(192, 8, 4, sep=6.0, seed=1)
    kind = "polynomial" if method == "tensorsketch" else (
        "linear" if method == "sketch" else "rbf")
    cfg = MiniBatchConfig(n_clusters=4, n_batches=2, seed=0, method=method,
                          kernel=KernelSpec(kind, gamma=0.5, degree=2),
                          embed_dim=32)
    off, on, path, c_off, c_on = _fit_on_off(
        tmp_path, lambda r: fit_dataset(x, cfg, device="cpu", recorder=r))
    assert _same_state(off.state, on.state)
    assert c_off == c_on
    marks = _events(path, kind="event", name="hbm_watermark")
    assert len(marks) == 2 and all(m["predicted_bytes"] > 0 for m in marks)
    assert len(_events(path, kind="series", name="batch/wall_seconds")) == 2
    costs = _events(path, kind="series", name="inner/cost")
    assert [c["value"] for c in costs] == pytest.approx(
        [h.cost for h in on.history])


def test_fit_list_batches_with_recorder(tmp_path):
    """fit() over CSR list batches (the sparse benchmark's shape) records
    without disturbing results; the watermark prices the O(nnz) path."""
    from repro_torch.data.sparse import split_csr
    from repro_torch.data.synthetic import make_rcv1_sparse
    xs, _ = make_rcv1_sparse(200, vocab=64, n_classes=4, seed=0)
    cfg = MiniBatchConfig(n_clusters=4, n_batches=2, seed=0,
                          kernel=KernelSpec("linear"), method="sketch",
                          embed_dim=32)
    off, on, path, c_off, c_on = _fit_on_off(
        tmp_path, lambda r: fit(split_csr(xs, 2, strategy="stride"), cfg,
                                device="cpu", recorder=r))
    assert _same_state(off.state, on.state) and c_off == c_on
    marks = _events(path, kind="event", name="hbm_watermark")
    assert len(marks) == 2 and all(m["predicted_bytes"] > 0 for m in marks)


@pytest.mark.parametrize("method", ["exact", "rff"])
def test_fit_records_as_the_reference_does(tmp_path, method):
    """The same config through both packages: the same record names,
    kinds and fields, and as many of each."""
    x, _ = make_blobs(160, 8, 4, sep=6.0, seed=0)
    kw = dict(n_clusters=4, n_batches=2, seed=0, method=method,
              embed_dim=0 if method == "exact" else 16)
    tpath, jpath = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    with JsonlRecorder(tpath) as rec:
        fit_dataset(x, MiniBatchConfig(kernel=_spec(), **kw), device="cpu",
                    recorder=rec)
    with jobs.JsonlRecorder(jpath) as rec:
        j_fit_dataset(x, JConfig(kernel=JSpec("rbf", gamma=0.5), **kw),
                      recorder=rec)
    assert _signature(tpath) == _signature(jpath)
    count = lambda p: sorted((e["kind"], e.get("name"))  # noqa: E731
                             for e in export.read_events(p))
    assert count(tpath) == count(jpath)


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_records_both_sides(tmp_path, prefetch):
    from repro_torch.data.loader import BatchSource
    x = np.arange(60, dtype=np.float32).reshape(12, 5)
    path = str(tmp_path / "load.jsonl")
    with JsonlRecorder(path) as rec:
        src = BatchSource([x[:4], x[4:8], x[8:]], device="cpu",
                          prefetch=prefetch, recorder=rec)
        got = [b for b in src]
        src.close()
    assert all(torch.equal(g, torch.from_numpy(x[4 * k:4 * k + 4]))
               for k, g in enumerate(got))
    stage = _events(path, kind="series", name="prefetch/stage_seconds")
    assert [s["index"] for s in stage] == [0, 1, 2]
    assert all(s["value"] >= 0 for s in stage)
    depth = _events(path, kind="gauge", name="prefetch/queue_depth")
    starve = _events(path, kind="series", name="prefetch/starve_seconds")
    if prefetch:
        assert "sync" not in stage[0] and len(depth) == len(starve) == 3
    else:
        assert all(s["sync"] for s in stage) and not depth and not starve


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------


def _service_artifact():
    from repro_torch.serving import freeze
    x, _ = make_blobs(256, 8, 4, seed=0)
    res = fit_dataset(x, MiniBatchConfig(n_clusters=4, n_batches=2,
                                         method="rff", embed_dim=16, seed=0),
                      device="cpu")
    return freeze(res), x


def test_service_records_and_program_count(tmp_path):
    from repro_torch.serving import (AssignServeConfig, AssignService,
                                     QueueFull, predict_frozen)
    art, x = _service_artifact()
    cfg = AssignServeConfig(buckets=(1, 8, 64), max_queue_rows=100)
    plain = AssignService(art, cfg)
    path = str(tmp_path / "svc.jsonl")
    rec = JsonlRecorder(path)
    svc = AssignService(art, cfg, recorder=rec)
    assert svc.compiled_programs == plain.compiled_programs == 3
    uids = [svc.submit(x[a:b]) for a, b in ((0, 1), (1, 9), (9, 80))]
    with pytest.raises(QueueFull):
        svc.submit(x[:30])
    done = svc.drain()
    rec.close()
    want = predict_frozen(art, x[:80]).numpy()
    np.testing.assert_array_equal(np.concatenate([done[u] for u in uids]),
                                  want)
    assert svc.compiled_programs == 3
    (warm,) = _events(path, name="serve/warm")
    assert warm["programs"] == 3 and warm["seconds"] >= 0
    sub = _events(path, kind="counter", name="serve/submitted")
    assert [e["rows"] for e in sub] == [1, 8, 71]
    (rej,) = _events(path, kind="counter", name="serve/rejected")
    assert rej["rows"] == 30 and rej["total"] == 1
    reqs = _events(path, name="serve/request")
    assert sorted(e["uid"] for e in reqs) == sorted(uids)
    for e in reqs:
        assert e["bucket"] in (1, 8, 64)
        assert 0 <= e["queue_seconds"] <= e["total_seconds"]
        assert 0 < e["compute_seconds"] <= e["total_seconds"]
    assert len(_events(path, name="serve/queue_seconds")) == 3
    assert len(_events(path, name="serve/compute_seconds")) == 3
    assert _events(path, name="serve/queue_rows")[-1]["value"] == 0


def test_service_records_as_the_reference_does(tmp_path):
    """The reference's service over its own artifact writes records of the
    same names, kinds and fields."""
    from repro.serving import AssignServeConfig as JServeConfig
    from repro.serving import AssignService as JService
    from repro.serving import QueueFull as JQueueFull
    from repro.serving import freeze as j_freeze
    from repro_torch.serving import (AssignServeConfig, AssignService,
                                     QueueFull)
    art, x = _service_artifact()
    jres = j_fit_dataset(x, JConfig(n_clusters=4, n_batches=2, method="rff",
                                    embed_dim=16, seed=0))
    paths = []
    for name, svc_cls, cfg_cls, full, a in (
            ("t", AssignService, AssignServeConfig, QueueFull, art),
            ("j", JService, JServeConfig, JQueueFull, j_freeze(jres))):
        path = str(tmp_path / f"{name}.jsonl")
        rec = (JsonlRecorder if name == "t" else jobs.JsonlRecorder)(path)
        svc = svc_cls(a, cfg_cls(buckets=(1, 8), max_queue_rows=12),
                      recorder=rec)
        svc.submit(x[:3])
        with pytest.raises(full):
            svc.submit(x[:10])
        svc.drain()
        rec.close()
        paths.append(path)
    assert _signature(paths[0]) == _signature(paths[1])


# ---------------------------------------------------------------------------
# the mesh: worlds 1 (in this process) and 2 (spawned), over gloo
# ---------------------------------------------------------------------------


def _mesh_layouts(world):
    """name -> (mesh axes, s_step): the 1-D and 2-D layouts at this world."""
    return {"1d": ({"data": world}, 1),
            "2d": ({"data": 1, "model": world}, 1),
            "1d-sstep": ({"data": world}, 2)}


def _mesh_case(world, out_dir):
    """Every mesh case at this world on this rank -> a picklable dict."""
    from repro_torch.distributed import (DistributedEmbedKMeans,
                                         DistributedMiniBatchKMeans,
                                         make_test_mesh)
    from repro_torch.distributed.embed import \
        collectives_per_iteration as embed_bill
    from repro_torch.distributed.inner import collectives_per_iteration
    from repro_torch.ft import CheckpointManager, ElasticClusteringRunner
    rank = torch.distributed.get_rank()
    x, _ = make_blobs(130, 6, 3, sep=6.0, seed=2)
    batches = [x[:66], x[66:]]
    out = {}

    def log(name):
        return os.path.join(out_dir, f"{name}-r{rank}.jsonl")

    for name, (axes, s_step) in _mesh_layouts(world).items():
        mesh = make_test_mesh(axes, device="cpu")
        cfg = MiniBatchConfig(n_clusters=3, n_batches=2, s=1.0,
                              kernel=_spec(), seed=0, engine="fused",
                              s_step=s_step)
        off = DistributedMiniBatchKMeans(mesh, cfg).fit(list(batches))
        _zero()
        with JsonlRecorder(log(name)) as rec:
            km = DistributedMiniBatchKMeans(mesh, cfg, recorder=rec)
            on = km.fit(list(batches))
        d = km.d_size
        rows_p = [(len(b) + (-len(b)) % d) // d for b in batches]
        ev = export.read_events(log(name))
        out[name] = {
            "same": _same_state(off.state, on.state),
            "iters": [h.inner_iters for h in on.history],
            "bill": [collectives_per_iteration(km.inner_cfg, r)
                     for r in rows_p],
            "counters": {n: [e["inc"] for e in ev if e.get("name") == n]
                         for n in ("collectives/psum",
                                   "collectives/allgather",
                                   "collectives/psum_bytes")},
            "timings": [e["timings"] for e in ev
                        if e.get("name") == "batch_timing"],
            "marks": sum(e.get("name") == "hbm_watermark" for e in ev),
            "walls": sum(e.get("name") == "batch/wall_seconds" for e in ev)}

    # the streaming embedded fit through the mesh's producer thread
    mesh = make_test_mesh({"data": world}, device="cpu")
    x, _ = make_blobs(192, 8, 4, sep=6.0, seed=3)
    ecfg = MiniBatchConfig(n_clusters=4, n_batches=3, kernel=_spec(),
                           seed=0, method="rff", embed_dim=32)
    batches = [x[:64], x[64:128], x[128:]]
    off = DistributedEmbedKMeans(mesh, ecfg).fit(list(batches))
    with JsonlRecorder(log("embed")) as rec:
        km = DistributedEmbedKMeans(mesh, ecfg, recorder=rec)
        on = km.fit(km.source(list(batches), depth=2))
    ev = export.read_events(log("embed"))

    def named(n, kind=None):
        return [e for e in ev if e.get("name") == n
                and (kind is None or e["kind"] == kind)]
    out["embed"] = {
        "same": _same_state(off.state, on.state),
        "iters": [h.inner_iters for h in on.history],
        "bill": embed_bill(4, 32),
        "psum": [e["inc"] for e in named("collectives/psum")],
        "psum_bytes": [e["inc"] for e in named("collectives/psum_bytes")],
        "depth": len(named("prefetch/queue_depth", "gauge")),
        "stage": [e["value"] for e in named("prefetch/stage_seconds")],
        "starve": len(named("prefetch/starve_seconds")),
        "stage_timer": len(named("stage/seconds", "timer")),
        "marks": [e["predicted_bytes"] for e in named("hbm_watermark")]}

    # the elastic runner: a fresh run, then a failed one resumed
    cfg = MiniBatchConfig(n_clusters=3, n_batches=2, kernel=_spec(), seed=0,
                          method="rff", embed_dim=16)
    x, _ = make_blobs(128, 6, 3, sep=6.0, seed=4)
    ckpt = CheckpointManager(os.path.join(out_dir, f"ckpt-{world}"))
    with JsonlRecorder(log("elastic")) as rec:
        runner = ElasticClusteringRunner(cfg, ckpt, recorder=rec)
        try:
            runner.run(mesh, [x[:64], x[64:]], fail_after=1)
        except Exception as e:          # the injected failure
            assert type(e).__name__ == "SimulatedFailure"
        runner.run(mesh, [x[:64], x[64:]])
    ev = export.read_events(log("elastic"))
    out["elastic"] = {
        "resume": [(e["resumed"], e["start_batch"], e["mesh_shape"])
                   for e in ev if e.get("name") == "elastic/resume"],
        "checkpoints": [e["batch"] for e in ev
                        if e.get("name") == "elastic/checkpoint"]}
    return out


def _init(rank, world, store_path):
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))


def _child(rank, world, store_path, out_dir):
    import warnings
    warnings.simplefilter("ignore")
    torch.set_num_threads(1)
    _init(rank, world, store_path)
    try:
        got = _mesh_case(world, out_dir)
    except Exception:
        got = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(got, f)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_logs(tmp_path_factory):
    """world -> [each rank's case results]."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    out = {}
    d1 = str(tmp_path_factory.mktemp("world1"))
    _init(0, 1, os.path.join(d1, "store"))
    try:
        out[1] = [_mesh_case(1, d1)]
    finally:
        dist.destroy_process_group()
    d2 = str(tmp_path_factory.mktemp("world2"))
    ctx = mp.start_processes(_child, args=(2, os.path.join(d2, "store"), d2),
                             nprocs=2, join=False, start_method="spawn")
    t0 = time.monotonic()
    try:
        while not ctx.join(timeout=max(0.1, DEADLINE
                                       - (time.monotonic() - t0))):
            if time.monotonic() - t0 > DEADLINE:
                pytest.fail(f"the world of 2 passed its {DEADLINE} s "
                            f"deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out[2] = []
    for r in range(2):
        with open(os.path.join(d2, f"rank{r}.pkl"), "rb") as f:
            got = pickle.load(f)
        assert "error" not in got, got["error"]
        out[2].append(got)
    return out


@pytest.mark.parametrize("layout", ["1d", "2d", "1d-sstep"])
@pytest.mark.parametrize("world", [1, 2])
def test_mesh_bill_is_the_analytic_one(mesh_logs, world, layout):
    """Recorder on = off bitwise; per batch the measured counters are the
    analytic bill a sync x (syncs + the prologue); one watermark, one wall
    time and one rank timing a batch."""
    for rank, got in enumerate(mesh_logs[world]):
        r = got[layout]
        assert r["same"]
        for b, (n_iter, bill) in enumerate(zip(r["iters"], r["bill"])):
            syncs = n_iter + 1
            assert r["counters"]["collectives/psum"][b] == \
                bill["psum"] * syncs
            assert r["counters"]["collectives/allgather"][b] == \
                bill["allgather"] * syncs
            assert r["counters"]["collectives/psum_bytes"][b] == \
                bill["psum_bytes"] * syncs
        assert r["marks"] == r["walls"] == 2
        assert r["timings"] == [{str(rank): t[str(rank)]}
                                for t in r["timings"]]
        assert len(r["timings"]) == 2


@pytest.mark.parametrize("world", [1, 2])
def test_mesh_embed_stream_records_both_threads(mesh_logs, world):
    for r in (got["embed"] for got in mesh_logs[world]):
        assert r["same"]
        assert r["depth"] == r["starve"] == r["stage_timer"] == 3
        assert len(r["stage"]) == 3 and all(v > 0 for v in r["stage"])
        bill = r["bill"]
        assert r["psum"] == [bill["psum"] * (t + 1) for t in r["iters"]]
        assert r["psum_bytes"] == [bill["psum_bytes"] * (t + 1)
                                   for t in r["iters"]]
        assert len(r["marks"]) == 3 and all(m > 0 for m in r["marks"])


@pytest.mark.parametrize("world", [1, 2])
def test_elastic_runner_events(mesh_logs, world):
    for r in (got["elastic"] for got in mesh_logs[world]):
        shape = {"data": world}
        assert r["resume"] == [(False, 0, shape), (True, 1, shape)]
        assert r["checkpoints"] == [0, 1]


def test_mesh_records_as_the_reference_does(tmp_path):
    """The exact mesh fit, the streaming embedded one and the elastic
    runner on the reference's one-device mesh and on the port's world of
    one: the same record names, kinds and fields."""
    import torch.distributed as dist
    from repro.distributed.embed import DistributedEmbedKMeans as JEmbed
    from repro.distributed.mesh import make_test_mesh as j_mesh
    from repro.distributed.outer import DistributedMiniBatchKMeans as JOuter
    from repro.ft import CheckpointManager as JCkpt
    from repro.ft import ElasticClusteringRunner as JRunner
    from repro_torch.distributed import (DistributedEmbedKMeans,
                                         DistributedMiniBatchKMeans,
                                         make_test_mesh)
    from repro_torch.ft import CheckpointManager, ElasticClusteringRunner
    x, _ = make_blobs(192, 6, 3, sep=6.0, seed=2)
    batches = [x[:96], x[96:]]
    kw = dict(n_clusters=3, n_batches=2, seed=0)
    ekw = dict(kw, method="rff", embed_dim=16)
    jm = j_mesh({"data": 1})
    jpaths = [str(tmp_path / f"j{k}.jsonl") for k in range(3)]
    jspec = JSpec("rbf", gamma=0.5)
    with jobs.JsonlRecorder(jpaths[0]) as rec:
        JOuter(jm, JConfig(kernel=jspec, **kw), recorder=rec).fit(
            list(batches))
    with jobs.JsonlRecorder(jpaths[1]) as rec:
        km = JEmbed(jm, JConfig(kernel=jspec, **ekw), recorder=rec)
        km.fit(km.source(list(batches), depth=2))
    with jobs.JsonlRecorder(jpaths[2]) as rec:
        JRunner(JConfig(kernel=jspec, **ekw), JCkpt(str(tmp_path / "jc")),
                recorder=rec).run(jm, list(batches))
    tpaths = [str(tmp_path / f"t{k}.jsonl") for k in range(3)]
    _init(0, 1, str(tmp_path / "store"))
    try:
        tm = make_test_mesh({"data": 1}, device="cpu")
        with JsonlRecorder(tpaths[0]) as rec:
            DistributedMiniBatchKMeans(
                tm, MiniBatchConfig(kernel=_spec(), **kw),
                recorder=rec).fit(list(batches))
        with JsonlRecorder(tpaths[1]) as rec:
            km = DistributedEmbedKMeans(
                tm, MiniBatchConfig(kernel=_spec(), **ekw), recorder=rec)
            km.fit(km.source(list(batches), depth=2))
        with JsonlRecorder(tpaths[2]) as rec:
            ElasticClusteringRunner(
                MiniBatchConfig(kernel=_spec(), **ekw),
                CheckpointManager(str(tmp_path / "tc")),
                recorder=rec).run(tm, list(batches))
    finally:
        dist.destroy_process_group()
    for t, j in zip(tpaths, jpaths):
        assert _signature(t) == _signature(j)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def test_launch_cluster_records_and_profiles(tmp_path, capsys):
    from repro_torch.launch import cluster
    path, prof = str(tmp_path / "cluster.jsonl"), str(tmp_path / "prof")
    acc = cluster.main(["--n", "600", "--d", "8", "--clusters", "4",
                        "--device", "cpu", "--b", "2", "--s", "0.5",
                        "--mode", "fused", "--ckpt-dir",
                        str(tmp_path / "ckpt"), "--obs", path,
                        "--profile", prof])
    out = capsys.readouterr().out
    assert acc > 0.9
    for line in ("[cluster] plan: B=2", "acc=", "displacement/batch",
                 "inner iters/batch", "profiler trace ->", "[cluster] obs:"):
        assert line in out
    (header,) = _events(path, kind="header")
    assert header["entry"] == "launch.cluster" and header["b"] == 2
    assert header["backend"] == "cpu" and header["mesh"] == {
        "data": 1, "model": 1}
    assert header["plan"]["b"] >= 1
    assert len(_events(path, kind="counter", name="collectives/psum")) == 2
    assert len(_events(path, name="hbm_watermark")) == 2
    assert len(_events(path, name="batch_timing")) == 2
    assert os.path.isdir(tmp_path / "ckpt")
    with open(os.path.join(prof, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"obs:engine_stats[fused]", "obs:allgather_u",
            "obs:psum_fused"} <= names
    assert not torch.distributed.is_initialized()


def test_launch_cluster_refuses_a_mesh_of_another_size(tmp_path):
    from repro_torch.launch import cluster
    with pytest.raises(ValueError, match="2 ranks, the world has 1"):
        cluster.main(["--n", "200", "--d", "4", "--clusters", "2",
                      "--device", "cpu", "--mesh", "2x1"])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("what", ["assign", "lm"])
def test_launch_serve_obs(tmp_path, what):
    from repro_torch.launch import serve
    path = str(tmp_path / "serve.jsonl")
    args = (["--assign", "synth", "--requests", "5"] if what == "assign"
            else ["--arch", "olmo-1b", "--smoke", "--requests", "2",
                  "--max-new-tokens", "2"])
    serve.main(args + ["--device", "cpu", "--obs", path])
    (header,) = _events(path, kind="header")
    assert header["entry"] == "launch.serve" and header["backend"] == "cpu"
    (summary,) = _events(path, name="serve/summary")
    assert summary["requests"] == (5 if what == "assign" else 2)
    if what == "assign":
        assert header["artifact_kind"] == "rff"
        assert summary["programs"] == 4
        assert len(_events(path, name="serve/request")) == 5
        assert len(_events(path, name="serve/warm")) == 1
    else:
        assert summary["tokens"] > 0 and summary["ticks"] > 0


def test_serve_bench_reads_the_split_from_the_log(tmp_path):
    from repro_torch.launch import serve, serve_bench
    from repro_torch.serving import AssignService
    art = serve.synth_artifact("cpu")
    path = str(tmp_path / "bench.jsonl")
    with JsonlRecorder(path) as rec:
        svc = AssignService(art, recorder=rec)
        got = serve_bench.bench(svc, qps_levels=(2000.0,), n_req=6)
    plain = serve_bench.bench(AssignService(art), qps_levels=(2000.0,),
                              n_req=6)
    assert got["compiled_programs"] == plain["compiled_programs"] == 4
    for cell in got["cells"].values():
        assert 0 <= cell["queue_p50_ms"] and 0 < cell["compute_p50_ms"]
    for cell in plain["cells"].values():
        assert cell["queue_p50_ms"] is None and cell["compute_p50_ms"] is None
    assert len(_events(path, name="serve/request")) == 12
