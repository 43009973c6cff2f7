"""The port's assignment serving (``repro_torch.serving.artifact`` and
``.assign``) against the JAX package's (``repro.serving``) on the CPU.

Artifacts cross the port through the reference's npz layout: a file
written by either package loads in the other with bitwise equal arrays
(bf16 tiles included), and both label the same rows equally. The port's
``freeze_map`` of a converted map equals the reference's arrays (tables
bitwise, f32 panels within 1e-5 relative). ``bucket_for`` equals the
reference's; padding with garbage changes no real label; the service packs
FIFO, admits up to its limit, rejects bad widths (dense or CSR), and holds
one program per bucket. CSR requests are held in ``test_torch_sparse.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.approx import make_nystrom as j_make_nystrom
from repro.approx import make_rff as j_make_rff
from repro.approx.sketch import make_count_sketch as j_make_count_sketch
from repro.approx.sketch import make_tensor_sketch as j_make_tensor_sketch
from repro.core import KernelSpec as JSpec
from repro.core import MiniBatchConfig as JConfig
from repro.core import fit_dataset as j_fit_dataset
from repro.data.synthetic import make_blobs as j_make_blobs
from repro.serving import artifact as jart
from repro.serving.assign import DEFAULT_BUCKETS as J_BUCKETS
from repro.serving.assign import bucket_for as j_bucket_for
from repro.serving.assign import predict as j_predict
from repro_torch import convert
from repro_torch.approx import predict_embedded
from repro_torch.core import KernelSpec, MiniBatchConfig, fit_dataset
from repro_torch.core import predict as exact_predict
from repro_torch.core.memory import serve_footprint_bytes
from repro_torch.data.synthetic import make_blobs
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve, serve_bench
from repro_torch.obs import JsonlRecorder, export
from repro_torch.serving import (DEFAULT_BUCKETS, AssignServeConfig,
                                 AssignService, QueueFull, artifact_nbytes,
                                 bucket_for, freeze, freeze_map,
                                 load_artifact, predict_frozen, save_artifact)
from repro_torch.serving.assign import run_bucket

PRECISIONS = ("f32", "bf16")
MAPS = ("rff", "nystrom", "sketch", "tensorsketch")
KINDS = MAPS + ("exact",)

_J_MAPS = {
    "rff": lambda key, d, m: j_make_rff(key, d, m,
                                        JSpec("rbf", gamma=0.5)),
    "nystrom": lambda key, d, m: j_make_nystrom(
        key, jax.random.normal(key, (4 * m, d)), m, JSpec("rbf", gamma=0.5)),
    "sketch": lambda key, d, m: j_make_count_sketch(key, d, m,
                                                    JSpec("linear")),
    "tensorsketch": lambda key, d, m: j_make_tensor_sketch(
        key, d, m, JSpec("polynomial", gamma=0.5, coef0=1.0, degree=2)),
}


def _port_map(fmap):
    """A reference feature map -> the port's, tables through numpy."""
    kind = {"RFFMap": "rff", "NystromMap": "nystrom",
            "CountSketchMap": "sketch",
            "TensorSketchMap": "tensorsketch"}[type(fmap).__name__]
    if kind == "rff":
        return convert.feature_map_from_numpy(
            kind, {"w": fmap.w, "b": fmap.b}, {"scale": fmap.scale}, "cpu")
    if kind == "nystrom":
        s = fmap.spec
        return convert.feature_map_from_numpy(
            kind, {"landmarks": fmap.landmarks, "proj": fmap.proj},
            dict(name=s.name, gamma=s.gamma, coef0=s.coef0, degree=s.degree),
            "cpu")
    if kind == "sketch":
        return convert.feature_map_from_numpy(
            kind, {"h": fmap.h, "sign": fmap.sign}, {"m": fmap.m}, "cpu")
    return convert.feature_map_from_numpy(
        kind, {"hs": fmap.hs, "signs": fmap.signs},
        dict(m=fmap.m, degree=fmap.degree, gamma=fmap.gamma,
             coef0=fmap.coef0), "cpu")


def _blob_parts(method, *, d=6, m=32, c=4, seed=0):
    """A reference map and well-separated blob centroids through it (the
    reference test's ``_blob_artifact`` inputs) and the query rows."""
    x, y = j_make_blobs(200, d, c, sep=8.0, seed=seed)
    fmap = _J_MAPS[method](jax.random.PRNGKey(seed), d, m)
    z = np.asarray(fmap(jnp.asarray(x)), np.float64)
    centroids = np.stack([z[y == j].mean(0) for j in range(c)]).astype(
        np.float32)
    counts = np.bincount(y, minlength=c).astype(np.float32)
    return fmap, centroids, counts, np.asarray(x, np.float32)


def _jax_artifact(kind, precision):
    if kind == "exact":
        x, _ = j_make_blobs(120, 5, 3, seed=1)
        res = j_fit_dataset(x, JConfig(n_clusters=3, n_batches=2,
                                       kernel=JSpec("rbf", gamma=0.5)))
        return jart.freeze(res, precision=precision), np.asarray(x)
    fmap, cents, counts, x = _blob_parts(kind)
    return jart.freeze_map(fmap, jnp.asarray(cents), jnp.asarray(counts),
                           precision=precision), x


def _port_artifact(kind, precision="f32", c=4):
    if kind == "exact":
        x, _ = make_blobs(120, 5, 3, seed=1)
        res = fit_dataset(x, MiniBatchConfig(
            n_clusters=3, n_batches=2, kernel=KernelSpec("rbf", gamma=0.5)),
            device="cpu")
        return freeze(res, precision=precision), x
    fmap, cents, counts, x = _blob_parts(kind, c=c)
    return freeze_map(_port_map(fmap), torch.from_numpy(cents),
                      torch.from_numpy(counts), precision=precision), x


def _np(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _port_np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("method", MAPS)
def test_freeze_map_matches_jax(method, precision):
    fmap, cents, counts, _ = _blob_parts(method)
    want = jart.freeze_map(fmap, jnp.asarray(cents), jnp.asarray(counts),
                           precision=precision)
    got = freeze_map(_port_map(fmap), torch.from_numpy(cents),
                     torch.from_numpy(counts), precision=precision)
    assert (got.kind, got.precision) == (want.kind, want.precision)
    assert sorted(got.arrays) == sorted(want.arrays)
    assert got.statics == pytest.approx(want.statics)
    for k, a in want.arrays.items():
        b = got.arrays[k]
        assert _port_np(b).dtype == _np(a).dtype, k
        if k in ("v", "csq", "centroids") or (k == "aux"
                                              and method == "nystrom"):
            np.testing.assert_allclose(b.float().numpy(), np.asarray(
                a, np.float32), rtol=1e-5, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(_port_np(b), _np(a), err_msg=k)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("kind", KINDS)
def test_npz_crosses_the_port_both_ways(tmp_path, kind, precision):
    """The reference's file loads in the port and the port's in the
    reference, arrays bitwise equal, and all four label alike."""
    art_j, x = _jax_artifact(kind, precision)
    p1, p2 = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jart.save_artifact(art_j, p1)
    art_t = load_artifact(p1, device="cpu")
    assert (art_t.kind, art_t.precision, art_t.statics) == \
        (art_j.kind, art_j.precision, art_j.statics)
    for k, a in art_j.arrays.items():
        np.testing.assert_array_equal(_port_np(art_t.arrays[k]), _np(a),
                                      err_msg=k)
    save_artifact(art_t, p2)
    art_j2 = jart.load_artifact(p2)
    for k, a in art_j.arrays.items():
        assert np.asarray(art_j2.arrays[k]).dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(_np(art_j2.arrays[k]), _np(a),
                                      err_msg=k)
    want = np.asarray(j_predict(art_j, x))
    np.testing.assert_array_equal(predict_frozen(art_t, x).numpy(), want)
    np.testing.assert_array_equal(np.asarray(j_predict(art_j2, x)), want)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("method", MAPS)
def test_serve_footprint_prices_the_artifact(method, precision):
    art, _ = _port_artifact(method, precision)
    assert serve_footprint_bytes(
        art.n_clusters, art.dim, art.in_dim, method=art.kind,
        q_tile=2 if precision == "bf16" else None,
        degree=int(art.statics.get("degree", 2))) == artifact_nbytes(art)


def test_exact_artifact_and_freeze_needs_the_spec():
    art, x = _port_artifact("exact")
    assert art.kind == "exact" and art.dim == 3
    assert serve_footprint_bytes(3, 0, 5, method="exact") == \
        artifact_nbytes(art)
    res = fit_dataset(x, MiniBatchConfig(n_clusters=3, n_batches=2),
                      device="cpu")
    with pytest.raises(ValueError, match="KernelSpec"):
        freeze(res._replace(spec=None))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_nystrom_aux_holds_the_norms_the_launch_sums(precision):
    """aux keeps the cast landmarks' squared norms for the file's sake;
    the launch and the plain version sum them from the tile values, and
    the two agree."""
    art, x = _port_artifact("nystrom", precision)
    w = art.arrays["w"].to(torch.float32)
    assert torch.equal(art.arrays["aux"][:, 0], torch.sum(w * w, dim=1))
    k = ref.kernel_matrix_ref(torch.from_numpy(x), art.arrays["w"],
                              kind="rbf", gamma=0.5, precision=precision)
    xf = ops.resolve_precision(precision).cast_tiles(
        torch.from_numpy(x)).float()
    d2 = (xf * xf).sum(1)[:, None] + art.arrays["aux"][:, 0][None] \
        - 2.0 * xf @ w.T
    torch.testing.assert_close(k, torch.exp(-0.5 * d2.clamp(min=0.0)),
                               rtol=1e-5, atol=1e-5)


def test_rff_phases_are_converted_once():
    art, _ = _port_artifact("rff")
    b = art.runtime["b"]
    assert b.shape == (art.dim,) and b.is_contiguous()
    assert torch.equal(b, art.arrays["aux"][:, 0])


# ---------------------------------------------------------------------------
# prediction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method,kw", [
    ("exact", dict(s=0.5)),
    ("rff", dict(method="rff")),
    ("orf", dict(method="rff", rff_orthogonal=True)),
    ("nystrom", dict(method="nystrom")),
    ("sketch", dict(method="sketch", kernel=KernelSpec("linear"))),
    ("tensorsketch", dict(method="tensorsketch", kernel=KernelSpec(
        "polynomial", gamma=0.5, coef0=1.0, degree=2)))])
def test_fit_predict_goes_through_the_ladder(method, kw):
    """FitResult.predict (frozen, bucketed) labels as the fit's own live
    path does, at every row count."""
    x, _ = make_blobs(700, 6, 4, sep=8.0, seed=2)
    kw = {"kernel": KernelSpec("rbf", gamma=0.5), **kw}
    res = fit_dataset(x, MiniBatchConfig(n_clusters=4, n_batches=2,
                                         embed_dim=32, seed=3, **kw),
                      device="cpu")
    xt = torch.from_numpy(x)
    live = (exact_predict(xt, res.state.medoids, res.state.medoid_diag,
                          spec=res.spec, device="cpu")
            if res.fmap is None else
            predict_embedded(xt, res.state, res.fmap, precision="f32",
                             device="cpu"))
    for n in (1, 7, 64, 600, 700):
        got = res.predict(x[:n])
        assert got.dtype == torch.int32 and got.shape == (n,)
        assert torch.equal(got, live[:n])


def test_predict_runs_only_ladder_shapes(monkeypatch):
    art, x = _port_artifact("rff")
    x = np.concatenate([x] * 4)
    seen = []
    real = ops.predict_assign

    def spy(xp, *a, **k):
        seen.append(xp.shape[0])
        return real(xp, *a, **k)
    monkeypatch.setattr(ops, "predict_assign", spy)
    for n in (1, 3, 8, 60, 65, 512, 800):
        predict_frozen(art, x[:n])
    assert set(seen) <= set(DEFAULT_BUCKETS)
    assert seen[-2:] == [512, 512]          # 800 = 512 + 288 -> 512


def test_bucket_for_matches_jax():
    for ladder in (DEFAULT_BUCKETS, (2, 16, 100)):
        assert J_BUCKETS == DEFAULT_BUCKETS
        for n in range(0, 2001):
            try:
                want = j_bucket_for(n, ladder)
            except ValueError:
                with pytest.raises(ValueError):
                    bucket_for(n, ladder)
                continue
            assert bucket_for(n, ladder) == want


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("kind", KINDS)
def test_garbage_padding_never_changes_a_real_label(kind, precision):
    """A 5-row query padded to its 8-bucket with rows of 1e6 instead of
    zeros: the real rows' labels are those of the clean bucket, and the
    service's sliced output equals them."""
    art, x = _port_artifact(kind, precision)
    rows = torch.from_numpy(x[:5])
    clean = torch.zeros((8, rows.shape[1]))
    clean[:5] = rows
    trapped = torch.full((8, rows.shape[1]), 1e6)
    trapped[:5] = rows
    l_clean = run_bucket(art, clean)
    assert torch.equal(run_bucket(art, trapped)[:5], l_clean[:5])
    svc = AssignService(art, AssignServeConfig(warm=False))
    assert torch.equal(svc.predict(rows), l_clean[:5])


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ladder", [DEFAULT_BUCKETS, (4, 32)])
def test_service_holds_one_program_per_bucket(kind, ladder):
    art, x = _port_artifact(kind)
    svc = AssignService(art, AssignServeConfig(buckets=ladder))
    assert svc.compiled_programs == len(ladder)
    svc.predict(x[:3])
    svc.predict(x[:100])
    assert svc.compiled_programs == len(ladder)
    lazy = AssignService(art, AssignServeConfig(buckets=ladder, warm=False))
    assert lazy.compiled_programs == 0
    lazy.predict(x[:2])
    assert lazy.compiled_programs == 1


def test_service_packs_fifo_and_completes_all(tmp_path):
    """Small requests ride one bucket, a large one drains across ticks;
    each gets its own rows' labels back, with its timings recorded in the
    flight recorder's ``serve/request`` events."""
    art, x = _port_artifact("rff")
    want = predict_frozen(art, x).numpy()
    path = str(tmp_path / "serve.jsonl")
    rec = JsonlRecorder(path)
    svc = AssignService(art, AssignServeConfig(buckets=(1, 8, 64),
                                               max_queue_rows=4096),
                        recorder=rec)
    slices = [(0, 2), (2, 5), (5, 6), (6, 40), (40, 200)]
    uids = {svc.submit(x[a:b]): (a, b) for a, b in slices}
    first = svc.step()                     # 2 + 3 + 1 + 34 + 24 = 64 rows
    assert sorted(first) == sorted(list(uids)[:4])
    done = {**first, **svc.drain()}
    assert sorted(done) == sorted(uids)
    for uid, (a, b) in uids.items():
        np.testing.assert_array_equal(done[uid], want[a:b])
    rec.close()
    recs = {r["uid"]: r for r in export.read_events(path)
            if r.get("name") == "serve/request"}
    assert sorted(recs) == sorted(uids)
    for r in recs.values():
        assert r["bucket"] in (1, 8, 64)
        assert r["rows"] == uids[r["uid"]][1] - uids[r["uid"]][0]
        assert 0.0 <= r["queue_seconds"] <= r["total_seconds"]
        assert 0.0 < r["compute_seconds"] <= r["total_seconds"]


def test_service_admission_control():
    art, x = _port_artifact("rff")
    svc = AssignService(art, AssignServeConfig(max_queue_rows=10, warm=False))
    svc.submit(x[:6])
    with pytest.raises(QueueFull):
        svc.submit(x[:5])
    svc.drain()
    svc.submit(x[:5])                      # capacity freed by the drain


def test_service_rejects_bad_width_empty_and_csr():
    art, x = _port_artifact("sketch")
    svc = AssignService(art, AssignServeConfig(warm=False))
    with pytest.raises(ValueError, match="queries must be"):
        svc.submit(np.zeros((3, art.in_dim + 1), np.float32))
    with pytest.raises(ValueError, match="empty"):
        svc.submit(np.zeros((0, art.in_dim), np.float32))
    # CSR requests are ported: the right width labels as the dense rows,
    # a wrong width raises as it does for dense rows
    csr = torch.from_numpy(x[:4]).to_sparse_csr()
    want = predict_frozen(art, x[:4])
    assert torch.equal(predict_frozen(art, csr), want)
    assert torch.equal(svc.predict(csr), want)
    narrow = torch.from_numpy(x[:4, :3]).to_sparse_csr()
    for call in (lambda: svc.submit(narrow),
                 lambda: predict_frozen(art, narrow)):
        with pytest.raises(ValueError, match="queries must be"):
            call()
    with pytest.raises(ValueError, match="queries must be"):
        predict_frozen(art, x[:, :3])
    with pytest.raises(ValueError, match="bucket"):
        AssignServeConfig(buckets=())


def test_launchers_run_on_the_cpu(tmp_path, capsys):
    svc = serve.main(["--assign", "synth", "--device", "cpu", "--requests",
                      "6", "--buckets", "1,8,64"])
    assert svc.compiled_programs == 3
    assert "[serve.assign] kind=rff" in capsys.readouterr().out
    path = str(tmp_path / "art.npz")
    save_artifact(svc.artifact, path)
    svc2 = serve.main(["--assign", path, "--device", "cpu", "--requests",
                       "3"])
    assert svc2.artifact.kind == "rff" and svc2.compiled_programs == 4
    rec = serve_bench.bench(AssignService(serve.synth_artifact("cpu")),
                            qps_levels=(2000.0,), n_req=6)
    assert rec["compiled_programs"] == 4 and rec["device"] == "cpu"
    assert set(rec["cells"]) == {"qps2000_rows1", "qps2000_rows64"}
    assert rec["artifact_bytes"] <= rec["predicted_bytes"]
    for cell in rec["cells"].values():
        assert 0 < cell["p50_ms"] <= cell["p99_ms"]
        assert cell["rows_per_s"] > 0


def test_serve_bench_eager_loop_on_the_cpu():
    """The eager baseline runs the same grid on the offline predict."""
    svc = AssignService(serve.synth_artifact("cpu"))
    rec = serve_bench.bench(svc, qps_levels=(2000.0,), n_req=6, eager=True)
    assert rec["loop"] == "eager"
    assert set(rec["cells"]) == {"qps2000_rows1", "qps2000_rows64"}
    for cell in rec["cells"].values():
        assert 0 < cell["p50_ms"] <= cell["p99_ms"]
        assert 0 < cell["compute_p50_ms"] and cell["rows_per_s"] > 0
