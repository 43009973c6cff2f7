"""Parity of the port's explicit feature-map methods (``repro_torch.approx``
and the ``embed_assign`` / ``sketch_assign`` wrappers) with the JAX package,
on the CPU.

The two packages draw different random numbers from one seed, so the maps
(RFF frequencies and phases, Nystrom landmarks, sketch hashes and signs)
and the k-means++ seeds are drawn by the JAX package and injected into the
port through ``repro_torch.convert``; with them, labels are equal. Fits that
draw their own are held by accuracy and NMI within 0.02.

Tolerances: the plain versions against ``repro.kernels.ref`` and the Pallas
kernels in interpret mode, labels equal and scores within 1e-4 (rtol and
atol) at f32 and bf16 (both round the same operands to bf16 and sum in
f32); feature maps within 1e-5; Nystrom on z z^T within 1e-4 (eigenvector
signs differ between libraries, z z^T does not); Lloyd centroids within
1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import four_blobs
from repro import approx as japprox
from repro.approx import embed_kmeans as j_embed
from repro.approx.selectors import RLSSelector as JRLSSelector
from repro.core import KernelSpec as JSpec
from repro.core import MiniBatchConfig as JConfig
from repro.core import fit_dataset as j_fit_dataset
from repro.core.init import kmeans_pp_indices as j_kmeans_pp
from repro.core.metrics import clustering_accuracy as j_acc
from repro.core.metrics import nmi as j_nmi
from repro.data import synthetic as j_synthetic
from repro.data.sparse import csr_from_dense
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import approx, convert
from repro_torch.approx import embed_kmeans
from repro_torch.approx.selectors import RLSSelector
from repro_torch.core import (KernelSpec, MiniBatchConfig, clustering_accuracy,
                              fit, fit_dataset, nmi)
from repro_torch.data import sampling, synthetic
from repro_torch.kernels import ops, ref
from repro_torch.kernels.precision import BF16, F32
from repro_torch.kernels.sketch_assign import bucket_tables

PRECS = ["f32", "bf16"]
EMBED_SHAPES = [(64, 16, 32, 5), (100, 30, 77, 13), (300, 40, 260, 130)]
SKETCH_SHAPES = [(64, 16, 32, 5), (100, 30, 77, 13), (300, 520, 260, 130)]
SPECS = {"rff": dict(name="rbf", gamma=0.5), "nystrom": dict(name="rbf",
                                                             gamma=0.5),
         "sketch": dict(name="linear"),
         "tensorsketch": dict(name="polynomial", gamma=1.0, coef0=0.5,
                              degree=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops (small here) on one thread beside the suite's
    other workers, some of which simulate 8-device JAX meshes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port_map(fmap):
    """A JAX feature map -> the port's, tables copied through numpy."""
    if isinstance(fmap, japprox.RFFMap):
        return convert.feature_map_from_numpy(
            "rff", {"w": fmap.w, "b": fmap.b}, {"scale": fmap.scale}, "cpu")
    if isinstance(fmap, japprox.NystromMap):
        s = fmap.spec
        return convert.feature_map_from_numpy(
            "nystrom", {"landmarks": fmap.landmarks, "proj": fmap.proj},
            dict(name=s.name, gamma=s.gamma, coef0=s.coef0, degree=s.degree),
            "cpu")
    if isinstance(fmap, japprox.CountSketchMap):
        return convert.feature_map_from_numpy(
            "sketch", {"h": fmap.h, "sign": fmap.sign}, {"m": fmap.m}, "cpu")
    return convert.feature_map_from_numpy(
        "tensorsketch", {"hs": fmap.hs, "signs": fmap.signs},
        dict(m=fmap.m, degree=fmap.degree, gamma=fmap.gamma,
             coef0=fmap.coef0), "cpu")


def _jax_map(method, x, m, seed=0, **kw):
    return japprox.make_feature_map(method, jax.random.PRNGKey(seed),
                                    jnp.asarray(x), m, JSpec(**SPECS[method]),
                                    **kw)


def _inputs(n, d, m, c, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(c, m)).astype(np.float32))


# ---------------------------------------------------------------------------
# the kernels' plain versions against the reference and its Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("shape", EMBED_SHAPES,
                         ids=["small", "ragged", "multiblock"])
@pytest.mark.parametrize("method", ["rff", "nystrom"])
def test_embed_assign_matches_jax(method, shape, prec):
    n, d, m, c = shape
    x, centroids = _inputs(n, d, m, c)
    fmap = _jax_map(method, x, m)
    counts = np.ones(c, np.float32)
    counts[1] = 0.0                                   # one empty cluster
    lab, score = ops.embed_assign(_t(x), _port_map(fmap), _t(centroids),
                                  _t(counts), precision=prec)
    # the reference's plain version, on the reference's panels
    w, aux, v, csq, statics = jops.embed_panels(fmap, jnp.asarray(centroids),
                                                jnp.asarray(counts))
    want_lab, want_score = jref.embed_assign_ref(
        jnp.asarray(x), w, v, csq, b=aux[:, 0] if method == "rff" else None,
        precision=prec, **statics)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab))
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score),
                               rtol=1e-4, atol=1e-4)
    assert not np.any(lab.numpy() == 1)
    # and the reference's Pallas kernel, in interpret mode
    p_lab, p_score = jops.embed_assign(jnp.asarray(x), fmap,
                                       jnp.asarray(centroids),
                                       jnp.asarray(counts), interpret=True,
                                       precision=prec)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(p_lab))
    np.testing.assert_allclose(score.numpy(), np.asarray(p_score),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("shape", SKETCH_SHAPES,
                         ids=["small", "ragged", "multiblock"])
def test_sketch_assign_matches_jax(shape, prec):
    n, d, m, c = shape
    x, centroids = _inputs(n, d, m, c)
    fmap = _jax_map("sketch", x, m)
    lab, score = ops.embed_assign(_t(x), _port_map(fmap), _t(centroids),
                                  precision=prec)
    c32 = jnp.asarray(centroids)
    csq = jnp.sum(c32 * c32, axis=1)
    want_lab, want_score = jref.sketch_assign_ref(
        jnp.asarray(x), fmap.h, fmap.sign, c32.T, csq, precision=prec)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab))
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score),
                               rtol=1e-4, atol=1e-4)
    p_lab, p_score = jops.embed_assign(jnp.asarray(x), fmap, c32,
                                       interpret=True, precision=prec)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(p_lab))
    np.testing.assert_allclose(score.numpy(), np.asarray(p_score),
                               rtol=1e-4, atol=1e-4)


def test_tensorsketch_takes_the_eager_path_like_jax():
    x, centroids = _inputs(80, 12, 32, 5)
    fmap = _jax_map("tensorsketch", x, 32)
    launches, calls = dict(ops.LAUNCHES), dict(ref.CALLS)
    lab, score = ops.embed_assign(_t(x), _port_map(fmap), _t(centroids),
                                  precision="bf16")
    want_lab, want_score = jops.embed_assign(jnp.asarray(x), fmap,
                                             jnp.asarray(centroids))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab))
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score),
                               rtol=1e-4, atol=1e-4)
    assert ops.LAUNCHES == launches and ref.CALLS == calls


@pytest.mark.parametrize("prec", PRECS)
def test_embedded_tie_takes_the_lowest_index(prec):
    """Two identical centroids tie exactly: both packages answer the first."""
    x, centroids = _inputs(60, 8, 16, 3, seed=7)
    centroids[2] = centroids[0]
    for method in ("rff", "sketch"):
        fmap = _jax_map(method, x, 16)
        lab, _ = ops.embed_assign(_t(x), _port_map(fmap), _t(centroids),
                                  precision=prec)
        assert not np.any(lab.numpy() == 2)
        want, _ = jops.embed_assign(jnp.asarray(x), fmap,
                                    jnp.asarray(centroids), interpret=True,
                                    precision=prec)
        np.testing.assert_array_equal(lab.numpy(), np.asarray(want))


def test_plain_versions_count_their_calls():
    x, centroids = _inputs(20, 8, 16, 3)
    before, launches = dict(ref.CALLS), dict(ops.LAUNCHES)
    for method in ("rff", "sketch"):
        ops.embed_assign(_t(x), _port_map(_jax_map(method, x, 16)),
                         _t(centroids))
    assert ref.CALLS["embed_assign_ref"] == before["embed_assign_ref"] + 1
    assert ref.CALLS["sketch_assign_ref"] == before["sketch_assign_ref"] + 1
    assert ops.LAUNCHES == launches      # CPU tensors never launch a kernel


def test_sign_table_is_int8_under_bf16():
    assert BF16.sign_dtype == torch.int8 and F32.sign_dtype == torch.float32


def test_bucket_tables_gather_the_sketch():
    """The sketch kernel's contract: bucket j owns the sorted columns
    order[offsets[j]:offsets[j+1]], in increasing order; summing sign * x
    over them in that order is the count sketch, and h = -1 lands nowhere."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(7, 40)).astype(np.float32))
    h = torch.from_numpy(rng.integers(-1, 9, 40).astype(np.int32))
    sign = torch.from_numpy(rng.choice([-1.0, 1.0], 40).astype(np.float32))
    order, offsets, sorted_sign = bucket_tables(h, sign, 9)
    assert order.dtype == offsets.dtype == torch.int32
    assert offsets.shape == (10,) and int(offsets[0]) == int((h < 0).sum())
    z = torch.zeros(7, 9)
    for j in range(9):
        cols = order[offsets[j]:offsets[j + 1]].long()
        assert bool((h[cols] == j).all()) and bool((cols.diff() > 0).all())
        for k, col in enumerate(cols):
            z[:, j] += sorted_sign[offsets[j] + k] * x[:, col]
    keep = h >= 0
    want = torch.zeros(7, 9).index_add_(1, h[keep].long(),
                                        x[:, keep] * sign[keep])
    torch.testing.assert_close(z, want, rtol=1e-6, atol=1e-6)


def _stand_in(plain, calls):
    """A launcher's contract on CPU tensors: check the chunk, then answer
    with the plain version's arithmetic."""
    def launch(*args, **kw):
        v, csq = args[-2], args[-1]
        assert v.shape[1] % 16 == 0 and 0 < v.shape[1] <= 256
        assert csq.shape == (v.shape[1],) and v.is_contiguous()
        calls.append(v.shape[1])
        return plain(*args, **kw)
    return launch


@pytest.mark.parametrize("n_clusters,chunks", [(10, [16]), (600, [256, 256,
                                                                  96])])
def test_cluster_chunks_merge_for_the_embedded_kernels(monkeypatch,
                                                       n_clusters, chunks):
    """Past 256 clusters both wrappers launch once per chunk, merged by
    lowest index, and answer like the one-pass plain version."""
    x, centroids = _inputs(120, 12, 24, n_clusters, seed=9)
    xt, ct = _t(x), _t(centroids)

    def embed_plain(x, w, b, v, csq, *, map_kind, scale, **_):
        return ref.embed_assign_ref(x, w, v, csq, map_kind=map_kind,
                                    scale=scale, b=b)

    def sketch_plain(x, order, offsets, sign, v, csq, programs):
        h = torch.empty(x.shape[1], dtype=torch.int32)
        for j in range(v.shape[0]):
            h[order[offsets[j]:offsets[j + 1]].long()] = j
        s = torch.empty_like(sign)
        s[order.long()] = sign
        return ref.sketch_assign_ref(x, h, s, v, csq)

    for method, name, plain in (("rff", "embed_assign_cuda", embed_plain),
                                ("sketch", "sketch_assign_cuda",
                                 sketch_plain)):
        calls = []
        monkeypatch.setattr(ops, name, _stand_in(plain, calls))
        fmap = _port_map(_jax_map(method, x, 24))
        c32, csq = ops._masked_csq(ct, None)
        if method == "rff":
            lab, score = ops._over_cluster_chunks(
                c32.T, csq, "embed_assign",
                lambda vc, cc: ops.embed_assign_cuda(
                    xt, fmap.w, fmap.b, vc, cc, map_kind="rff", gamma=1.0,
                    coef0=1.0, degree=1, scale=fmap.scale))
        else:
            order, offsets, sign = fmap.buckets
            lab, score = ops._over_cluster_chunks(
                c32.T, csq, "sketch_assign",
                lambda vc, cc: ops.sketch_assign_cuda(
                    xt, order, offsets, sign, vc, cc,
                    programs=fmap.programs))
        assert calls == chunks
        want_lab, want_score = ops.embed_assign(xt, fmap, ct)
        assert torch.equal(lab, want_lab)
        torch.testing.assert_close(score, want_score, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("method", ["rff", "nystrom"])
def test_embed_assign_wrapper_passes_no_row_norms(monkeypatch, method, prec):
    """On the card ops.embed_assign hands the launcher the cast tiles, the
    phases (rff only) and the panels, and computes no row norms of x or w
    at either dtype: the Mercer kinds' launch sums them itself. The answer
    is the plain version's."""
    x, centroids = _inputs(120, 12, 24, 10, seed=10)
    xt, ct = _t(x), _t(centroids)
    fmap = _port_map(_jax_map(method, x, 24))
    want_lab, want_score = ops.embed_assign(xt, fmap, ct, precision=prec)

    def embed_plain(x, w, b, v, csq, *, map_kind, gamma, coef0, degree,
                    scale):
        return ref.embed_assign_ref(x, w, v, csq, map_kind=map_kind,
                                    gamma=gamma, coef0=coef0, degree=degree,
                                    scale=scale, b=b, precision="f32")

    seen, norms = [], []
    monkeypatch.setattr(ops, "embed_assign_cuda", lambda *a, **kw:
                        seen.append(a) or embed_plain(*a, **kw))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    real_norm = torch.linalg.vector_norm
    monkeypatch.setattr(torch.linalg, "vector_norm", lambda *a, **kw:
                        norms.append(a) or real_norm(*a, **kw))
    lab, score = ops.embed_assign(xt, fmap, ct, precision=prec)
    (xo, wo, b, v, csq), = seen
    dtype = torch.bfloat16 if prec == "bf16" else torch.float32
    assert xo.dtype == wo.dtype == dtype and norms == []
    assert xo.shape[0] == 120 and wo.shape[0] == 24
    if method == "rff":
        assert torch.equal(b, fmap.b.to(torch.float32))
    else:
        assert b is None
    # bf16 pads the clusters to the kernel's multiple; f32 masks them itself
    assert v.shape == (24, 16 if prec == "bf16" else 10)
    assert torch.equal(lab, want_lab)
    torch.testing.assert_close(score, want_score, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# feature maps from injected tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["rff", "orf", "sketch", "tensorsketch"])
def test_feature_maps_match_jax(case):
    x, _ = _inputs(50, 12, 24, 1, seed=3)
    method = "rff" if case == "orf" else case
    fmap = _jax_map(method, x, 24, orthogonal=(case == "orf"))
    got = _port_map(fmap)(_t(x))
    assert got.dtype == torch.float32 and got.shape == (50, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(fmap(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def test_port_maps_have_the_reference_contract():
    """Maps drawn by the port: shapes, dtypes, the rff scale, ORF rows with
    orthogonal directions, and the kernel gates."""
    gen = torch.Generator().manual_seed(0)
    x = torch.from_numpy(_inputs(40, 6, 1, 1)[0])
    for method in ("rff", "nystrom", "sketch", "tensorsketch"):
        fmap = approx.make_feature_map(method, gen, x, 12,
                                       KernelSpec(**SPECS[method]))
        assert fmap.dim == 12 and fmap.in_dim == 6 and fmap.kind == method
        z = fmap(x)
        assert z.shape == (40, 12) and z.dtype == torch.float32
    orf = approx.make_rff(gen, 6, 12, KernelSpec("rbf", gamma=0.5),
                          orthogonal=True, device="cpu")
    block = orf.w[:6] / orf.w[:6].norm(dim=1, keepdim=True)
    torch.testing.assert_close(block @ block.T, torch.eye(6), atol=1e-5,
                               rtol=0)
    assert orf.scale == pytest.approx((2 / 12) ** 0.5)
    with pytest.raises(ValueError, match="shift-invariant"):
        approx.make_rff(gen, 4, 16, KernelSpec("polynomial"), device="cpu")
    with pytest.raises(ValueError, match="linear"):
        approx.make_count_sketch(gen, 4, 16, KernelSpec("rbf"), device="cpu")
    with pytest.raises(ValueError, match="gamma"):
        approx.make_tensor_sketch(gen, 4, 16,
                                  KernelSpec("polynomial", gamma=-1.0),
                                  device="cpu")
    with pytest.raises(ValueError):
        approx.make_feature_map("bogus", gen, x, 16, KernelSpec())


@pytest.mark.parametrize("make,spec", [
    (approx.make_rff, KernelSpec("rbf")),
    (approx.make_count_sketch, KernelSpec("linear")),
    (approx.make_tensor_sketch, KernelSpec("polynomial", gamma=0.5))],
    ids=["rff", "sketch", "tensorsketch"])
def test_map_constructor_without_device_raises_here(make, spec):
    """device=None means the card, as for every entry point."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(gen, 4, 16, spec)
    fmap = make(gen, 4, 16, spec, device="cpu")
    assert fmap.dim == 16 and fmap(torch.ones(3, 4)).shape == (3, 16)


def test_count_sketch_is_bitwise_repeatable():
    """The dense sketch is one product with the map's signed one-hot matrix
    (a fixed sum order): equal to the scatter-add up to rounding, and
    bitwise equal across calls."""
    fmap = approx.make_count_sketch(torch.Generator().manual_seed(1), 300,
                                    32, KernelSpec("linear"), device="cpu")
    x = torch.from_numpy(_inputs(64, 300, 1, 1, seed=2)[0])
    z = fmap(x)
    assert torch.equal(z, fmap(x))
    assert fmap.matrix.shape == (300, 32)
    assert torch.equal((fmap.matrix != 0).sum(dim=1), torch.ones(300).long())
    scatter = torch.zeros(64, 32).index_add_(1, fmap.h.long(),
                                             x * fmap.sign[None])
    torch.testing.assert_close(z, scatter, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["rbf", "polynomial"])
def test_nystrom_matches_jax_on_z_zt(kind):
    """Eigenvector signs differ between libraries; z z^T does not."""
    x, _ = _inputs(120, 6, 1, 1, seed=5)
    spec_kw = dict(name=kind, gamma=0.5) if kind == "rbf" else dict(
        name=kind, gamma=0.2, coef0=1.0, degree=2)
    landmarks = x[:30]
    jmap = japprox.nystrom_from_landmarks(jnp.asarray(landmarks),
                                          JSpec(**spec_kw))
    tmap = approx.nystrom_from_landmarks(_t(landmarks), KernelSpec(**spec_kw))
    zj = np.asarray(jmap(jnp.asarray(x)))
    zt = tmap(_t(x)).numpy()
    np.testing.assert_allclose(zt @ zt.T, zj @ zj.T, rtol=1e-4, atol=1e-4)
    # exact on the landmark set itself
    zl = tmap(_t(landmarks))
    np.testing.assert_allclose((zl @ zl.T).numpy(),
                               np.asarray(JSpec(**spec_kw)(
                                   jnp.asarray(landmarks),
                                   jnp.asarray(landmarks))),
                               rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# Lloyd, the batch steps and whole fits
# ---------------------------------------------------------------------------


def test_lloyd_fit_matches_jax_from_injected_z():
    x, y = four_blobs(seed=3)
    fmap = _jax_map("rff", x, 16)
    z = np.asarray(fmap(jnp.asarray(x)))
    labels0 = np.random.default_rng(0).integers(0, 4, len(x)).astype(np.int32)
    res_j = j_embed.lloyd_fit(jnp.asarray(z), jnp.asarray(labels0),
                              n_clusters=4, max_iters=50)
    res_t = embed_kmeans.lloyd_fit(_t(z), _t(labels0), n_clusters=4,
                                   max_iters=50)
    np.testing.assert_array_equal(res_t.labels.numpy(),
                                  np.asarray(res_j.labels))
    assert res_t.n_iter == int(res_j.n_iter)
    np.testing.assert_allclose(res_t.centroids.numpy(),
                               np.asarray(res_j.centroids), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(res_t.counts.numpy(),
                                  np.asarray(res_j.counts))
    np.testing.assert_allclose(float(res_t.cost), float(res_j.cost),
                               rtol=1e-4)


def _jax_seeds(z, seed, n_clusters):
    """The k-means++ draw of the reference's first embedded batch."""
    zj = jnp.asarray(z)
    return np.asarray(j_kmeans_pp(
        zj, jnp.sum(zj.astype(jnp.float32) ** 2, axis=1),
        jax.random.fold_in(jax.random.PRNGKey(seed), 0),
        n_clusters=n_clusters, spec=JSpec("linear")))


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("method", ["rff", "nystrom", "sketch",
                                    "tensorsketch"])
def test_fit_dataset_with_jax_draws_matches_jax(monkeypatch, method, prec):
    """The whole fit with the reference's map and k-means++ seeds injected:
    equal labels, iterations and cardinalities, centroids within 1e-4."""
    x, _ = four_blobs()
    kw = dict(n_clusters=4, n_batches=4, seed=0, method=method,
              embed_dim=16, precision=prec)
    res_j = j_fit_dataset(x, JConfig(kernel=JSpec(**SPECS[method]), **kw))
    first = sampling.split_batches(x, 4)[0]
    z0 = BF16.cast_tiles(_port_map(res_j.fmap)(_t(first))) \
        if prec == "bf16" else _port_map(res_j.fmap)(_t(first))
    seeds = _jax_seeds(z0.float().numpy() if prec == "f32" else
                       np.asarray(jnp.asarray(z0.float().numpy()).astype(
                           jnp.bfloat16)), 0, 4)
    monkeypatch.setattr(embed_kmeans, "draw_first",
                        lambda z, gen, n_clusters: torch.from_numpy(seeds))
    res_t = fit_dataset(x, MiniBatchConfig(kernel=KernelSpec(**SPECS[method]),
                                           **kw),
                        device="cpu", fmap=_port_map(res_j.fmap))
    assert [h.inner_iters for h in res_t.history] == [
        h.inner_iters for h in res_j.history]
    np.testing.assert_array_equal(res_t.state.cardinalities.numpy(),
                                  np.asarray(res_j.state.cardinalities))
    np.testing.assert_allclose(res_t.state.centroids.numpy(),
                               np.asarray(res_j.state.centroids), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(res_t.predict(x).numpy(),
                                  np.asarray(res_j.predict(x)))


@pytest.mark.parametrize("method", ["rff", "nystrom", "sketch",
                                    "tensorsketch"])
def test_free_running_fit_reaches_the_jax_scores(method):
    x, y = four_blobs(seed=1)
    kw = dict(n_clusters=4, n_batches=4, seed=0, method=method)
    res_t = fit_dataset(x, MiniBatchConfig(kernel=KernelSpec(**SPECS[method]),
                                           **kw), device="cpu")
    res_j = j_fit_dataset(x, JConfig(kernel=JSpec(**SPECS[method]), **kw))
    lab_t, lab_j = res_t.predict(x).numpy(), np.asarray(res_j.predict(x))
    assert res_t.fmap.dim == approx.default_embed_dim(4) == res_j.fmap.dim
    np.testing.assert_allclose(
        [clustering_accuracy(y, lab_t), nmi(y, lab_t)],
        [j_acc(y, lab_j), j_nmi(y, lab_j)], atol=0.02)
    assert int(res_t.state.cardinalities.sum()) == len(x)


def test_predict_embedded_fused_equals_materialized():
    """The fused path and assign_embedded(fmap(x)) agree, an empty cluster
    with a zero centroid included, at both precisions."""
    x, centroids = _inputs(40, 8, 16, 3, seed=6)
    centroids[1] = 0.0
    state = convert.embed_state_from_numpy(centroids, [10.0, 0.0, 10.0], 1,
                                           "cpu")
    for method in ("rff", "nystrom", "sketch", "tensorsketch"):
        fmap = _port_map(_jax_map(method, x, 16))
        for prec in PRECS:
            fused = approx.predict_embedded(x, state, fmap, precision=prec,
                                            device="cpu")
            plain = approx.predict_embedded(x, state, fmap, use_fused=False,
                                            precision=prec, device="cpu")
            assert torch.equal(fused, plain) and not bool((fused == 1).any())
    if not torch.cuda.is_available():     # device=None means the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            approx.predict_embedded(x, state, fmap)


def test_embedded_resume_and_state_conversion():
    """A fit resumed from the state after batch 0, with its map, ends where
    the uninterrupted fit ends; the state survives numpy."""
    x, _ = four_blobs(seed=2)
    cfg = MiniBatchConfig(n_clusters=4, n_batches=4,
                          kernel=KernelSpec("rbf", gamma=8.0), method="rff")
    batches = sampling.split_batches(x, 4)
    saved = {}
    full = fit(batches, cfg, device="cpu",
               checkpoint_cb=lambda st, i: saved.setdefault(i, st))
    st = convert.embed_state_from_numpy(
        **convert.embed_state_to_numpy(saved[0]), device="cpu")
    resumed = fit(batches[1:], cfg, state=st, fmap=full.fmap, device="cpu")
    np.testing.assert_array_equal(resumed.state.centroids.numpy(),
                                  full.state.centroids.numpy())
    assert resumed.state.batches_done == full.state.batches_done == 4
    with pytest.raises(ValueError, match="fmap"):
        fit(batches[1:], cfg, state=st, device="cpu")


def test_config_validation_matches_jax():
    """The port accepts the embedded methods and rejects what the
    reference rejects, with the same exception type."""
    for method in ("rff", "nystrom", "sketch", "tensorsketch"):
        assert MiniBatchConfig(n_clusters=2, method=method, embed_dim=8,
                               rff_orthogonal=True).embed_dim == 8
    bad = [dict(method="bogus"), dict(method="rff", selector="rls"),
           dict(method="sketch", selector="kpp"),
           dict(method="rff", engine="fused"),
           dict(method="nystrom", engine="tiled"),
           dict(method="rff", precision="fp8")]
    for kw in bad:
        with pytest.raises(ValueError):
            JConfig(n_clusters=2, **kw)
        with pytest.raises(ValueError):
            MiniBatchConfig(n_clusters=2, **kw)
    # a precision-only engine is no engine choice, in both packages
    JConfig(n_clusters=2, method="rff", precision="bf16")
    MiniBatchConfig(n_clusters=2, method="rff", precision="bf16")
    # the leverage-aware selectors apply to nystrom, as names or instances
    for sel in ("rls", "kpp", RLSSelector(delta=1e-3)):
        JConfig(n_clusters=2, method="nystrom",
                selector=sel if isinstance(sel, str) else
                JRLSSelector(delta=1e-3))
        MiniBatchConfig(n_clusters=2, method="nystrom", selector=sel)


def test_csr_batches_wait_for_the_ingestion_slice():
    """CSR batches no longer wait: they raised until sparse rows and
    ingestion were ported, and now the reference's CSR batch and a torch
    ``sparse_csr`` tensor go through the map, ``fit_dataset`` and ``fit``,
    and embed and label as their dense rows do."""
    x, _ = _inputs(30, 12, 1, 1)
    x[x < 0.5] = 0.0
    csr = csr_from_dense(x)
    fmap = _port_map(_jax_map("sketch", x, 8))
    cfg = MiniBatchConfig(n_clusters=2, kernel=KernelSpec("linear"),
                          method="sketch")
    tcsr = torch.from_numpy(x).to_sparse_csr()
    for batch in (csr, tcsr):
        torch.testing.assert_close(fmap(batch), fmap(_t(x)), rtol=1e-5,
                                   atol=1e-5)
    a = fit_dataset(csr, cfg, device="cpu", fmap=fmap)
    b = fit([tcsr], cfg, device="cpu", fmap=fmap)
    assert torch.equal(a.state.centroids, b.state.centroids)
    assert torch.equal(a.predict(csr), b.predict(tcsr))
    assert torch.equal(a.predict(csr), a.predict(x))


def test_make_rcv1_like_matches_jax():
    for n, c in ((400, 6), (1000, 50)):
        (xa, ya) = synthetic.make_rcv1_like(n, n_classes=c, seed=3)
        (xb, yb) = j_synthetic.make_rcv1_like(n, n_classes=c, seed=3)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
        assert xa.shape == (n, 256) and xa.dtype == np.float32


def test_laplacian_nystrom_predicts_only_through_the_materialized_path():
    """laplacian has no in-tile epilogue: FitResult.predict and the fused
    path (predict_embedded's default) raise ValueError, as the reference's
    FitResult.predict does; use_fused=False materializes the embedding."""
    x, y = four_blobs(seed=4)
    kw = dict(n_clusters=4, n_batches=2, method="nystrom")
    res = fit_dataset(x, MiniBatchConfig(
        kernel=KernelSpec("laplacian", gamma=4.0), **kw), device="cpu")
    res_j = j_fit_dataset(x, JConfig(kernel=JSpec("laplacian", gamma=4.0),
                                     **kw))
    for call in (lambda: res_j.predict(x), lambda: res.predict(x),
                 lambda: approx.predict_embedded(x, res.state, res.fmap,
                                                 device="cpu"),
                 lambda: ops.embed_assign(_t(x), res.fmap,
                                          res.state.centroids)):
        with pytest.raises(ValueError, match="laplacian"):
            call()
    labels = approx.predict_embedded(x, res.state, res.fmap, use_fused=False,
                                     device="cpu")
    assert nmi(y, labels.numpy()) >= 0.9
