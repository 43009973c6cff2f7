"""Sparse rows in the port (``repro_torch.data.sparse``, the O(nnz) sketch
path of ``repro_torch.approx.sketch``, CSR fits and CSR requests) against
the JAX package (``repro.data.sparse``, ``repro.approx.sketch``,
``repro.serving``) on the CPU, on the same numpy inputs.

The CSR helpers must give the reference's arrays exactly (values; the port
builds its indptr in int64). ``make_rcv1_sparse`` must give the reference's
corpus bit for bit. The CSR sketch maps, with the reference's tables
injected, give z within 1e-6 normwise (both sum each slot in stored order;
the port by a stable sort and a segment sum) and within 1e-5 of the port's
dense path. Fits on CSR batches with the reference's map and k-means++
seeds injected give equal labels and iterations, at f32 and bf16, and equal
the port's fit on the densified rows. CSR requests label as the
reference's predict on the same rows, the service as ``predict_frozen``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from repro import approx as japprox
from repro.core import KernelSpec as JSpec
from repro.core import MiniBatchConfig as JConfig
from repro.core import fit_dataset as j_fit_dataset
from repro.core.init import kmeans_pp_indices as j_kmeans_pp
from repro.data import sparse as jsp
from repro.data import synthetic as j_synthetic
from repro.data.synthetic import make_blobs as j_make_blobs
from repro.serving import artifact as jart
from repro.serving.assign import predict as j_predict
from repro_torch import approx, convert
from repro_torch.approx import embed_kmeans
from repro_torch.core import (KernelSpec, MiniBatchConfig, fit, fit_dataset,
                              nmi)
from repro_torch.data import sparse as tsp
from repro_torch.data import synthetic
from repro_torch.kernels.precision import BF16
from repro_torch.obs import JsonlRecorder, export
from repro_torch.serving import (AssignServeConfig, AssignService,
                                 load_artifact, predict_frozen)
from repro_torch.serving.assign import _pad_csr, run_csr_bucket

PRECS = ["f32", "bf16"]
SPECS = {"sketch": dict(name="linear"),
         "tensorsketch": dict(name="polynomial", gamma=1.0, coef0=0.5,
                              degree=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops (small here) on one thread beside the suite's
    other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _random_sparse(n, d, density, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32)
            * (rng.random((n, d)) < density))


def _port(b) -> tsp.CSRBatch:
    """A reference CSRBatch -> the port's, through numpy."""
    return convert.csr_from_numpy(b.data, b.indices, b.indptr, b.shape,
                                  "cpu")


def _same(port_batch, jax_batch):
    """Equal arrays (values) and shape."""
    assert tuple(port_batch.shape) == tuple(jax_batch.shape)
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(port_batch, f).numpy(),
                                      np.asarray(getattr(jax_batch, f)))


def _normwise(got, want):
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# data/sparse.py against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,vocab,c,seed", [(300, 200, 4, 0),
                                            (1200, 4096, 30, 3)])
def test_make_rcv1_sparse_matches_jax(n, vocab, c, seed):
    xa, ya = synthetic.make_rcv1_sparse(n, vocab=vocab, n_classes=c,
                                        seed=seed)
    xb, yb = j_synthetic.make_rcv1_sparse(n, vocab=vocab, n_classes=c,
                                          seed=seed)
    _same(xa, xb)
    assert xa.data.dtype == torch.float32 and xa.indices.dtype == torch.int32
    np.testing.assert_array_equal(ya, yb)


@pytest.mark.parametrize("n,d,density", [(37, 53, 0.1), (12, 5, 0.0),
                                         (20, 6, 1.0)])
def test_csr_dense_round_trip_matches_jax(n, d, density):
    x = _random_sparse(n, d, density, seed=n)
    mine, theirs = tsp.csr_from_dense(x), jsp.csr_from_dense(x)
    _same(mine, theirs)
    assert mine.nnz == theirs.nnz == int((x != 0).sum()) and len(mine) == n
    np.testing.assert_array_equal(tsp.to_dense(mine).numpy(), x)
    np.testing.assert_array_equal(tsp.row_ids(mine).numpy(),
                                  np.asarray(jsp.row_ids(theirs)))
    # batches from outside the port convert through their arrays
    for foreign in (theirs, scipy.sparse.csr_matrix(x),
                    torch.from_numpy(x).to_sparse_csr()):
        assert tsp.is_sparse(foreign)
        np.testing.assert_array_equal(
            tsp.to_dense(tsp.as_csr(foreign)).numpy(), x)
    assert not tsp.is_sparse(x) and not tsp.is_sparse(torch.from_numpy(x))
    back = convert.csr_to_numpy(mine)
    _same(convert.csr_from_numpy(**back, device="cpu"), theirs)


@pytest.mark.parametrize("strategy", ["stride", "block"])
@pytest.mark.parametrize("n_batches", [1, 3, 7])
def test_split_csr_matches_jax(strategy, n_batches):
    x = _random_sparse(22, 11, 0.35, 4)
    mine = tsp.split_csr(tsp.csr_from_dense(x), n_batches, strategy)
    theirs = jsp.split_csr(jsp.csr_from_dense(x), n_batches, strategy)
    assert len(mine) == len(theirs) == n_batches
    for a, b in zip(mine, theirs):
        _same(a, b)


def test_take_slice_concat_match_jax():
    x = _random_sparse(31, 9, 0.4, 2)
    mine, theirs = tsp.csr_from_dense(x), jsp.csr_from_dense(x)
    idx = np.asarray([30, 4, 4, 0, 17])
    _same(tsp.take_rows(mine, idx), jsp.take_rows(theirs, idx))
    cuts = [(0, 4), (4, 4), (4, 20), (20, 31)]
    parts = [tsp.slice_rows(mine, i, j) for i, j in cuts]
    for p, (i, j) in zip(parts, cuts):
        _same(p, jsp.slice_rows(theirs, i, j))
    assert parts[1].shape == (0, 9)
    _same(tsp.concat_csr(parts),
          jsp.concat_csr([jsp.slice_rows(theirs, i, j) for i, j in cuts]))
    with pytest.raises(ValueError, match="column counts"):
        tsp.concat_csr([mine, tsp.csr_from_dense(np.ones((2, 3)))])
    with pytest.raises(ValueError, match="start <= stop"):
        tsp.slice_rows(mine, 5, 2)


@pytest.mark.parametrize("rows,nnz_multiple", [(None, 1), (12, 8), (9, 64)])
def test_pad_csr_capacity_matches_jax(rows, nnz_multiple):
    """Slack slots hold zeros in column 0 past indptr[-1]; to_dense reads
    only the rows."""
    x = _random_sparse(9, 7, 0.5, 1)
    cuts = [(0, 2), (2, 9), (9, 9)]
    mine = tsp.pad_csr_capacity(
        [tsp.slice_rows(tsp.csr_from_dense(x), i, j) for i, j in cuts],
        rows=rows, nnz_multiple=nnz_multiple)
    theirs = jsp.pad_csr_capacity(
        [jsp.slice_rows(jsp.csr_from_dense(x), i, j) for i, j in cuts],
        rows=rows, nnz_multiple=nnz_multiple)
    for a, b, (i, j) in zip(mine, theirs, cuts):
        _same(a, b)
        assert a.nnz % nnz_multiple == 0 and a.nnz >= tsp.stored(a)
        want = np.zeros((len(a), 7), np.float32)
        want[:j - i] = x[i:j]
        np.testing.assert_array_equal(tsp.to_dense(a).numpy(), want)
    with pytest.raises(ValueError, match="rows"):
        tsp.pad_csr_capacity([tsp.csr_from_dense(x)], rows=3)


@pytest.mark.parametrize("n,d,density,p", [
    (23, 17, 0.3, 1), (23, 17, 0.3, 3), (24, 8, 0.5, 4), (5, 8, 0.0, 2),
    (7, 8, 0.4, 10), (64, 33, 0.05, 8)])
def test_shard_csr_matches_jax_and_the_dense_row_split(n, d, density, p):
    x = _random_sparse(n, d, density, seed=n + p)
    mine = tsp.shard_csr(tsp.csr_from_dense(x), p, nnz_multiple=4)
    theirs = jsp.shard_csr(jsp.csr_from_dense(x), p, nnz_multiple=4)
    mask = tsp.shard_row_mask(n, p)
    np.testing.assert_array_equal(mask.numpy(), jsp.shard_row_mask(n, p))
    rows = -(-n // p)
    assert len(mine) == p
    for k, (a, b) in enumerate(zip(mine, theirs)):
        _same(a, b)
        want = np.zeros((rows, d), np.float32)
        blk = x[min(k * rows, n):min((k + 1) * rows, n)]
        want[:len(blk)] = blk
        np.testing.assert_array_equal(tsp.to_dense(a).numpy(), want)
        assert int(mask[k].sum()) == len(blk)
    with pytest.raises(ValueError, match="n_shards"):
        tsp.shard_csr(tsp.csr_from_dense(x), 0)


# ---------------------------------------------------------------------------
# the O(nnz) sketch maps
# ---------------------------------------------------------------------------


def _maps(case, x, m):
    """(reference map, the port's map with its tables) for ``case``."""
    fmap = japprox.make_feature_map(case, jax.random.PRNGKey(0),
                                    jnp.asarray(x), m, JSpec(**SPECS[case]))
    if case == "sketch":
        return fmap, convert.feature_map_from_numpy(
            "sketch", {"h": fmap.h, "sign": fmap.sign}, {"m": m}, "cpu")
    return fmap, convert.feature_map_from_numpy(
        "tensorsketch", {"hs": fmap.hs, "signs": fmap.signs},
        dict(m=m, degree=fmap.degree, gamma=fmap.gamma, coef0=fmap.coef0),
        "cpu")


@pytest.mark.parametrize("case", ["sketch", "tensorsketch"])
@pytest.mark.parametrize("n,d,m,density", [(50, 64, 32, 0.08),
                                           (37, 300, 16, 0.3),
                                           (9, 5, 64, 0.0)])
def test_csr_sketch_maps_match_jax(case, n, d, m, density):
    x = _random_sparse(n, d, density, seed=d)
    jmap, tmap = _maps(case, x, m)
    b = tsp.csr_from_dense(x)
    z = tmap(b)
    assert z.shape == (n, m) and z.dtype == torch.float32
    want = np.asarray(jmap(jsp.csr_from_dense(x)))
    assert _normwise(z.numpy(), want) <= 1e-6
    # the port's own dense path, and the reference's batch taken as it is
    assert _normwise(z.numpy(), tmap(torch.from_numpy(x)).numpy()) <= 1e-5
    assert torch.equal(tmap(jsp.csr_from_dense(x)), z)
    if case == "sketch":
        assert torch.equal(z, approx.count_sketch_features_csr(b, tmap))
    else:
        assert torch.equal(z, approx.tensor_sketch_features_csr(b, tmap))


@pytest.mark.parametrize("case", ["sketch", "tensorsketch"])
def test_csr_sketch_ignores_slack_and_repeats_bitwise(case):
    """Slack slots (here filled with garbage) and padded empty rows add
    nothing: each shard's z is the oracle's rows, bitwise; two calls are
    bitwise equal."""
    x = _random_sparse(19, 32, 0.3, 1)
    _, tmap = _maps(case, x, 16)
    z_all = tmap(tsp.csr_from_dense(x))
    rows = 5
    for k, s in enumerate(tsp.shard_csr(tsp.csr_from_dense(x), 4,
                                        nnz_multiple=16)):
        k0 = tsp.stored(s)
        s.data[k0:] = 1e6
        s.indices[k0:] = 31
        z = tmap(s)
        real = min(rows, 19 - k * rows)
        assert torch.equal(z[:real], z_all[k * rows:k * rows + real])
        assert torch.equal(z, tmap(s))


def test_dense_maps_refuse_a_csr_sample_like_jax():
    b = jsp.csr_from_dense(_random_sparse(16, 8, 0.2, 4))
    gen = torch.Generator().manual_seed(0)
    for method in ("rff", "nystrom"):
        with pytest.raises(ValueError, match="dense"):
            japprox.make_feature_map(method, jax.random.PRNGKey(0), b, 16,
                                     JSpec("rbf"))
        with pytest.raises(ValueError, match="dense"):
            approx.make_feature_map(method, gen, b, 16, KernelSpec("rbf"))
    fmap = approx.make_feature_map("sketch", gen, b, 16,
                                   KernelSpec("linear"))
    assert fmap.in_dim == 8 and fmap.h.device.type == "cpu"


# ---------------------------------------------------------------------------
# fits on CSR batches
# ---------------------------------------------------------------------------


def _corpus():
    """A clear-margin corpus: few classes over a small vocabulary."""
    return j_synthetic.make_rcv1_sparse(480, vocab=256, n_classes=4, seed=5)


def _injected_fit(monkeypatch, method, prec, xs, batches):
    """The reference's CSR fit, then the port's on ``batches`` with its map
    and first k-means++ seeds injected."""
    kw = dict(n_clusters=4, n_batches=3, seed=0, method=method,
              embed_dim=32, precision=prec)
    res_j = j_fit_dataset(xs, JConfig(kernel=JSpec(**SPECS[method]), **kw))
    _, tmap = _maps_from(res_j.fmap)
    first = jsp.split_csr(xs, 3)[0]
    z0 = np.asarray(res_j.fmap(first))
    if prec == "bf16":
        z0 = np.asarray(jnp.asarray(z0).astype(jnp.bfloat16))
    zj = jnp.asarray(z0)
    seeds = np.asarray(j_kmeans_pp(
        zj, jnp.sum(zj.astype(jnp.float32) ** 2, axis=1),
        jax.random.fold_in(jax.random.PRNGKey(0), 0), n_clusters=4,
        spec=JSpec("linear")))
    monkeypatch.setattr(embed_kmeans, "draw_first",
                        lambda z, gen, n_clusters: torch.from_numpy(seeds))
    cfg = MiniBatchConfig(kernel=KernelSpec(**SPECS[method]), **kw)
    return res_j, fit_dataset(batches, cfg, device="cpu", fmap=tmap), tmap


def _maps_from(jmap):
    if isinstance(jmap, japprox.CountSketchMap):
        return jmap, convert.feature_map_from_numpy(
            "sketch", {"h": jmap.h, "sign": jmap.sign}, {"m": jmap.m}, "cpu")
    return jmap, convert.feature_map_from_numpy(
        "tensorsketch", {"hs": jmap.hs, "signs": jmap.signs},
        dict(m=jmap.m, degree=jmap.degree, gamma=jmap.gamma,
             coef0=jmap.coef0), "cpu")


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("method", ["sketch", "tensorsketch"])
def test_csr_fit_with_jax_draws_matches_jax(monkeypatch, method, prec):
    """The whole CSR fit with the reference's map and seeds injected: equal
    labels, iterations and cardinalities; centroids within 1e-4."""
    xs, y = _corpus()
    res_j, res_t, _ = _injected_fit(monkeypatch, method, prec, xs, _port(xs))
    assert [h.inner_iters for h in res_t.history] == [
        h.inner_iters for h in res_j.history]
    np.testing.assert_array_equal(res_t.state.cardinalities.numpy(),
                                  np.asarray(res_j.state.cardinalities))
    np.testing.assert_allclose(res_t.state.centroids.numpy(),
                               np.asarray(res_j.state.centroids), rtol=1e-4,
                               atol=1e-4)
    labels = res_t.predict(_port(xs)).numpy()
    np.testing.assert_array_equal(labels, np.asarray(res_j.predict(xs)))
    # real clusters, not noise (the reference's own bounds, test_sketch.py)
    assert nmi(y, labels) >= (0.5 if method == "sketch" else 0.3)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("method", ["sketch", "tensorsketch"])
def test_csr_fit_equals_the_dense_oracle_fit(monkeypatch, method, prec):
    """The port's CSR fit and its fit on the densified rows (same map and
    seeds): equal labels and iterations, centroids within 1e-4."""
    xs, _ = _corpus()
    _, res_csr, tmap = _injected_fit(monkeypatch, method, prec, xs,
                                     _port(xs))
    dense = torch.from_numpy(jsp.to_dense(xs))
    cfg = MiniBatchConfig(n_clusters=4, n_batches=3, seed=0, method=method,
                          embed_dim=32, precision=prec,
                          kernel=KernelSpec(**SPECS[method]))
    res_dense = fit_dataset(dense, cfg, device="cpu", fmap=tmap)
    assert [h.inner_iters for h in res_csr.history] == [
        h.inner_iters for h in res_dense.history]
    np.testing.assert_allclose(res_csr.state.centroids.numpy(),
                               res_dense.state.centroids.numpy(),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(res_csr.predict(_port(xs)), res_dense.predict(dense))
    state = res_csr.state
    assert torch.equal(
        approx.predict_embedded(_port(xs), state, tmap, precision=prec,
                                device="cpu"),
        approx.predict_embedded(dense, state, tmap, use_fused=False,
                                precision=prec, device="cpu"))


def test_free_running_csr_fit_equals_its_dense_fit():
    """Without injected draws: one seed draws one map whatever the row
    format, so the CSR fit and the fit on the densified rows give equal
    labels; the clusters are real (the reference's bound) and every row is
    counted once."""
    xs, y = j_synthetic.make_rcv1_sparse(900, vocab=256, n_classes=4,
                                         seed=1)
    cfg = MiniBatchConfig(n_clusters=4, n_batches=3, seed=0,
                          method="sketch", embed_dim=64,
                          kernel=KernelSpec("linear"))
    res_csr = fit_dataset(_port(xs), cfg, device="cpu")
    dense = torch.from_numpy(jsp.to_dense(xs))
    res_dense = fit_dataset(dense, cfg, device="cpu")
    assert torch.equal(res_csr.fmap.h, res_dense.fmap.h)
    labels = res_csr.predict(_port(xs))
    assert torch.equal(labels, res_dense.predict(dense))
    assert int(res_csr.state.cardinalities.sum()) == 900
    assert nmi(y, labels.numpy()) >= 0.5


def test_exact_method_rejects_csr_batches_like_jax():
    b = _random_sparse(30, 8, 0.5, 6)
    cfg = MiniBatchConfig(n_clusters=3, n_batches=2)
    with pytest.raises(ValueError, match="exact.*CSRBatch"):
        j_fit_dataset(jsp.csr_from_dense(b), JConfig(n_clusters=3,
                                                     n_batches=2))
    for call in (lambda: fit_dataset(tsp.csr_from_dense(b), cfg,
                                     device="cpu"),
                 lambda: fit([jsp.csr_from_dense(b)], cfg, device="cpu")):
        with pytest.raises(ValueError, match="exact.*CSRBatch"):
            call()
    with pytest.raises(ValueError, match="dense"):
        approx.predict_embedded(
            tsp.csr_from_dense(b), None,
            approx.make_rff(torch.Generator().manual_seed(0), 8, 16,
                            KernelSpec("rbf"), device="cpu"), device="cpu")


# ---------------------------------------------------------------------------
# CSR requests: predict_frozen and the service
# ---------------------------------------------------------------------------


def _jax_map(kind, key, d, m):
    from repro.approx import make_nystrom, make_rff
    from repro.approx.sketch import make_count_sketch, make_tensor_sketch
    if kind == "rff":
        return make_rff(key, d, m, JSpec("rbf", gamma=0.5))
    if kind == "nystrom":
        return make_nystrom(key, jax.random.normal(key, (4 * m, d)), m,
                            JSpec("rbf", gamma=0.5))
    if kind == "sketch":
        return make_count_sketch(key, d, m, JSpec("linear"))
    return make_tensor_sketch(key, d, m, JSpec("polynomial", gamma=0.5,
                                               coef0=1.0, degree=2))


def _artifacts(kind, precision, tmp_path):
    """A reference artifact over sparse blob rows, and the port's load of
    its npz file."""
    x, y = j_make_blobs(300, 12, 4, sep=8.0, seed=2)
    x = np.asarray(x, np.float32)
    x[np.random.default_rng(0).random(x.shape) < 0.4] = 0.0
    if kind == "exact":
        res = j_fit_dataset(x, JConfig(n_clusters=4, n_batches=2,
                                       kernel=JSpec("rbf", gamma=0.05)))
        art = jart.freeze(res, precision=precision)
    else:
        fmap = _jax_map(kind, jax.random.PRNGKey(1), 12, 32)
        z = np.asarray(fmap(jnp.asarray(x)), np.float64)
        cents = np.stack([z[y == j].mean(0) for j in range(4)]).astype(
            np.float32)
        counts = np.bincount(y, minlength=4).astype(np.float32)
        art = jart.freeze_map(fmap, jnp.asarray(cents), jnp.asarray(counts),
                              precision=precision)
    path = str(tmp_path / f"{kind}.npz")
    jart.save_artifact(art, path)
    return art, load_artifact(path, device="cpu"), x


@pytest.mark.parametrize("precision", PRECS)
@pytest.mark.parametrize("kind", ["sketch", "tensorsketch", "rff",
                                  "nystrom", "exact"])
def test_csr_predict_frozen_matches_jax(tmp_path, kind, precision):
    """Sketch kinds through the O(nnz) program, the others densified: the
    reference's labels on the same CSR rows, which equal the dense rows'."""
    jart_, art, x = _artifacts(kind, precision, tmp_path)
    rows = x[:141]
    want = np.asarray(j_predict(jart_, jsp.csr_from_dense(rows)))
    got = predict_frozen(art, tsp.csr_from_dense(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        predict_frozen(art, jsp.csr_from_dense(rows)).numpy(), want)
    if not (kind == "tensorsketch" and precision == "bf16"):
        # the reference rounds TensorSketch's CSR values to bf16, and not
        # its dense rows (an f32 FFT path with no tile knob)
        np.testing.assert_array_equal(predict_frozen(art, rows).numpy(),
                                      want)
    # chunks past the largest bucket, and a CSR batch of the wrong width
    np.testing.assert_array_equal(
        predict_frozen(art, tsp.csr_from_dense(rows),
                       buckets=(1, 8, 64)).numpy(), want)
    with pytest.raises(ValueError, match="queries must be"):
        predict_frozen(art, tsp.csr_from_dense(rows[:, :5]))


@pytest.mark.parametrize("precision", PRECS)
def test_service_csr_requests_label_as_predict_frozen(tmp_path, precision):
    """Ragged CSR requests, dense ones between them: the service's labels
    equal predict_frozen's on the same rows, and CSR ticks pack FIFO heads
    up to the largest bucket."""
    _, art, x = _artifacts("sketch", precision, tmp_path)
    want = predict_frozen(art, x).numpy()
    path = str(tmp_path / "serve.jsonl")
    rec = JsonlRecorder(path)
    svc = AssignService(art, AssignServeConfig(buckets=(1, 8, 64),
                                               max_queue_rows=4096),
                        recorder=rec)
    cuts = [(0, 3), (3, 10), (10, 11), (11, 80), (80, 150), (150, 300)]
    kinds = ["csr", "csr", "dense", "csr", "csr", "dense"]
    uids = {}
    for (a, b), k in zip(cuts, kinds):
        rows = x[a:b] if k == "dense" else jsp.csr_from_dense(x[a:b])
        uids[svc.submit(rows)] = (a, b)
    done = svc.drain()
    assert sorted(done) == sorted(uids)
    for uid, (a, b) in uids.items():
        np.testing.assert_array_equal(done[uid], want[a:b])
    assert svc.compiled_programs == 3
    rec.close()
    buckets = [r["bucket"] for r in export.read_events(path)
               if r.get("name") == "serve/request"]
    assert buckets[:3] == [64, 64, 1]


@pytest.mark.parametrize("kind", ["rff", "exact"])
def test_service_densifies_csr_for_the_dense_kinds(tmp_path, kind):
    _, art, x = _artifacts(kind, "f32", tmp_path)
    svc = AssignService(art, AssignServeConfig(warm=False))
    u_csr = svc.submit(tsp.csr_from_dense(x[:70]))
    u_dense = svc.submit(x[:70])
    done = svc.drain()
    np.testing.assert_array_equal(done[u_csr], done[u_dense])
    np.testing.assert_array_equal(done[u_csr],
                                  predict_frozen(art, x[:70]).numpy())


@pytest.mark.parametrize("precision", PRECS)
def test_csr_garbage_padding_never_perturbs_real_rows(tmp_path, precision):
    """Pad a 5-row CSR query to its 8-row bucket with garbage: the padded
    rows hold 1e6 values and the slack slots 1e6 in the last column. The
    real rows' labels equal the clean bucket's and the reference's."""
    jart_, art, x = _artifacts("sketch", precision, tmp_path)
    rows = tsp.csr_from_dense(x[:5])
    clean = _pad_csr(rows, 8)
    assert clean.nnz & (clean.nnz - 1) == 0 and len(clean) == 8
    junk = tsp.csr_from_dense(np.full((3, 12), 1e6, np.float32))
    trapped = tsp.pad_csr_capacity([tsp.concat_csr([rows, junk])],
                                   nnz_multiple=128)[0]
    k = tsp.stored(trapped)
    trapped.data[k:] = 1e6
    trapped.indices[k:] = 11
    got = run_csr_bucket(art, clean)[:5]
    assert torch.equal(got, run_csr_bucket(art, trapped)[:5])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_predict(jart_, jsp.csr_from_dense(x[:5]))))


@pytest.mark.parametrize("d,m,c,itemsize,staged", [
    (10880, 256, 50, 4, False), (10881, 256, 50, 4, False),
    (47236, 256, 50, 4, False), (47236, 256, 50, 2, False),
    (47236, 128, 50, 4, False), (47236, 128, 50, 2, False),
    (4096, 128, 300, 4, False), (256, 128, 50, 4, True)])
def test_sketch_assign_geometry_answers_every_width(monkeypatch, d, m, c,
                                                    itemsize, staged):
    """``geometry`` answers for every D and the wrapper launches at every
    width: the gather program is read in place wherever staging it would
    cost the bucket chunk or a CTA an SM, so Tab.2's 47,236-term
    vocabulary launches dense with every bucket in one chunk (C = 300
    takes a 256-cluster launch and a 48-cluster one)."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import sketch_assign as sk
    seen = []
    fmap = approx.make_count_sketch(torch.Generator().manual_seed(0), d, m,
                                    KernelSpec("linear"), device="cpu")
    monkeypatch.setattr(build, "launch", lambda entry, *a: seen.append(a))
    monkeypatch.setattr(sk, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    ops.sketch_assign(torch.randn(3, d), fmap, torch.randn(c, m),
                      precision="bf16" if itemsize == 2 else "f32")
    monkeypatch.undo()
    cps = [min(c - lo, sk.MAX_CP) for lo in range(0, c, sk.MAX_CP)]
    cps = [-(-cp // sk.CP_MULTIPLE) * sk.CP_MULTIPLE for cp in cps]
    assert [a[11] for a in seen] == cps
    nch = -(-d // sk.chunk_features(itemsize))
    for args, cp in zip(seen, cps):
        mb, per_sm, got = sk.geometry(d, m, cp, itemsize)
        assert got == staged
        assert mb == -(-m // 8) * 8
        assert args[12:15] == (mb, sk.grid(3, 132, per_sm), int(staged))
        assert sk.smem_bytes(d, nch, m, cp, mb, staged=got) <= sk.SMEM_BLOCK


def _wide_sketch_artifact(precision, tmp_path):
    """A reference count-sketch artifact over Tab.2's 47,236-term
    vocabulary (centroids: class means of the sketched rows), and the
    port's load of its npz file, with the CSR rows."""
    xs, y = j_synthetic.make_rcv1_sparse(240, vocab=47236, n_classes=4,
                                         seed=3)
    fmap = _jax_map("sketch", jax.random.PRNGKey(4), 47236, 64)
    z = np.asarray(fmap(xs), np.float64)
    y = np.asarray(y)
    cents = np.stack([z[y == j].mean(0) for j in range(4)]).astype(
        np.float32)
    counts = np.bincount(y, minlength=4).astype(np.float32)
    art = jart.freeze_map(fmap, jnp.asarray(cents), jnp.asarray(counts),
                          precision=precision)
    path = str(tmp_path / "wide.npz")
    jart.save_artifact(art, path)
    return art, load_artifact(path, device="cpu"), xs


@pytest.mark.parametrize("precision", PRECS)
def test_wide_sketch_artifact_serves_dense_and_csr_rows(tmp_path, precision):
    """A sketch artifact at 47,236 columns builds a program per bucket and
    serves dense and CSR requests alike: the dense rows label as their CSR
    rows and as the reference's predict on the same rows."""
    jart_, art, xs = _wide_sketch_artifact(precision, tmp_path)
    rows = jsp.slice_rows(xs, 0, 70)
    want = np.asarray(j_predict(jart_, rows))
    dense = np.asarray(jsp.to_dense(rows))
    svc = AssignService(art, AssignServeConfig(buckets=(1, 8, 64)))
    assert svc.compiled_programs == 3
    u_dense = svc.submit(dense)
    u_csr = svc.submit(_port(rows))
    done = svc.drain()
    np.testing.assert_array_equal(done[u_dense], want)
    np.testing.assert_array_equal(done[u_csr], want)
    np.testing.assert_array_equal(predict_frozen(art, dense).numpy(), want)
