"""Parity of the port's Gram engine and inner loop (``repro_torch.core``)
with the JAX package's, on the CPU (the plain path of the kernels).

From the same injected landmarks and initial labels (the style of
tests/test_engine.py), each engine mode of the port must give the JAX
mode's labels and iteration count exactly, and its f, g, counts and cost
within 1e-4, at both tile precisions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import GramEngine as JEngine
from repro.core import KernelSpec as JSpec
from repro.core import gamma_from_dmax as j_gamma_from_dmax
from repro.core import kkmeans_fit as j_kkmeans_fit
from repro.core import kkmeans_fit_gram as j_kkmeans_fit_gram
from repro.core.engine import assign_from_stats as j_assign_from_stats
from repro.core.kkmeans import kkmeans_fit_full as j_kkmeans_fit_full
from repro.core.kkmeans import medoid_indices as j_medoid_indices
from repro_torch.core import GramEngine, KernelSpec, gamma_from_dmax
from repro_torch.core import engine as engine_mod
from repro_torch.core import kkmeans_fit, kkmeans_fit_full, kkmeans_fit_gram
from repro_torch.core.engine import (GramRows, assign_from_stats,
                                     resolve_engine)
from repro_torch.core.kkmeans import medoid_indices
from repro_torch.kernels import ops

MODES = ["materialize", "fused", "tiled"]
PRECS = ["f32", "bf16"]
ALL_KINDS = ["rbf", "linear", "polynomial", "cosine", "laplacian"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine, some of them
    simulating 8-device JAX meshes whose collectives time out when
    starved: keep torch's CPU ops (small here) on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _problem(n=200, d=6, c=5, s=0.4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    l_idx = np.sort(rng.choice(n, int(n * s), replace=False)).astype(np.int32)
    u0 = rng.integers(0, c, n).astype(np.int32)
    return x, l_idx, u0, c


def _engines(mode, prec):
    if mode == "tiled":
        return (GramEngine("tiled", tile_rows=64, precision=prec),
                JEngine("tiled", tile_rows=64, precision=prec))
    # the JAX fused mode on the CPU runs its jnp recompute unless asked for
    # the Pallas kernel in interpret mode
    return GramEngine(mode, precision=prec), JEngine(mode, precision=prec)


def _fit_both(x, l_idx, u0, c, kind, mode, prec, **kw):
    spec_t = KernelSpec(kind, gamma=0.3, coef0=1.0, degree=2)
    spec_j = JSpec(kind, gamma=0.3, coef0=1.0, degree=2)
    eng_t, eng_j = _engines(mode, prec)
    eng_j = kw.pop("jax_engine", eng_j)
    xt = torch.from_numpy(x)
    got = kkmeans_fit(xt, torch.from_numpy(l_idx).long(), spec_t.diag(xt),
                      torch.from_numpy(u0), spec=spec_t, n_clusters=c,
                      engine=eng_t)
    xj = jnp.asarray(x)
    want = j_kkmeans_fit(xj, jnp.asarray(l_idx), spec_j.diag(xj),
                         jnp.asarray(u0), spec=spec_j, n_clusters=c,
                         engine=eng_j)
    return got, want


def _assert_same(got, want, tol=1e-4):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.n_iter == int(want.n_iter)
    np.testing.assert_allclose(got.f.numpy(), np.asarray(want.f),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got.g.numpy(), np.asarray(want.g),
                               rtol=tol, atol=tol)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=tol)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("mode", MODES)
def test_kkmeans_fit_matches_jax(mode, prec):
    x, l_idx, u0, c = _problem()
    got, want = _fit_both(x, l_idx, u0, c, "rbf", mode, prec)
    _assert_same(got, want)
    assert got.labels.dtype == torch.int32 and got.n_iter > 1


@pytest.mark.parametrize("prec", PRECS)
def test_fused_matches_jax_pallas_kernel_in_interpret_mode(prec):
    x, l_idx, u0, c = _problem(n=120, s=0.5, seed=1)
    got, want = _fit_both(
        x, l_idx, u0, c, "rbf", "fused", prec,
        jax_engine=JEngine("fused", pallas="always", interpret=True,
                           precision=prec))
    _assert_same(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["linear", "polynomial", "cosine",
                                  "laplacian"])
def test_other_kernels_match_jax(kind, mode):
    x, l_idx, u0, c = _problem(n=160, d=5, s=0.5, seed=3)
    got, want = _fit_both(x, l_idx, u0, c, kind, mode, "f32")
    _assert_same(got, want)


def test_kkmeans_fit_gram_and_full_match_jax():
    x, l_idx, u0, c = _problem(n=150, seed=2)
    spec = JSpec("rbf", gamma=0.3)
    xj = jnp.asarray(x)
    k_xl = np.array(spec(xj, xj[l_idx]))
    k_full = np.array(spec(xj, xj))
    diag = np.ones(len(x), np.float32)
    got = kkmeans_fit_gram(torch.from_numpy(k_xl),
                           torch.from_numpy(l_idx).long(),
                           torch.from_numpy(diag), torch.from_numpy(u0),
                           n_clusters=c)
    want = j_kkmeans_fit_gram(jnp.asarray(k_xl), jnp.asarray(l_idx),
                              jnp.asarray(diag), jnp.asarray(u0), n_clusters=c)
    _assert_same(got, want)
    got = kkmeans_fit_full(torch.from_numpy(k_full), torch.from_numpy(diag),
                           torch.from_numpy(u0), n_clusters=c)
    want = j_kkmeans_fit_full(jnp.asarray(k_full), jnp.asarray(diag),
                              jnp.asarray(u0), n_clusters=c)
    _assert_same(got, want)


@pytest.mark.parametrize("restrict", [False, True])
def test_medoid_indices_match_jax(restrict):
    rng = np.random.default_rng(7)
    n, c = 90, 6
    diag = rng.random(n).astype(np.float32)
    f = rng.random((n, c)).astype(np.float32)
    labels = rng.integers(0, c - 1, n).astype(np.int32)     # cluster 5 empty
    counts = np.bincount(labels, minlength=c).astype(np.float32)
    got = medoid_indices(torch.from_numpy(diag), torch.from_numpy(f),
                         torch.from_numpy(labels), torch.from_numpy(counts),
                         restrict_to_members=restrict)
    want = j_medoid_indices(jnp.asarray(diag), jnp.asarray(f),
                            jnp.asarray(labels), jnp.asarray(counts),
                            restrict_to_members=restrict)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_assign_from_stats_tie_break_and_empty_clusters():
    f = np.array([[1.0, 1.0, 5.0], [0.0, 2.0, 2.0], [3.0, 1.0, 3.0]],
                 np.float32)
    g = np.array([0.0, 0.0, 0.0], np.float32)
    counts = np.array([4.0, 3.0, 0.0], np.float32)        # cluster 2 empty
    lab, mind = assign_from_stats(torch.from_numpy(f), torch.from_numpy(g),
                                  torch.from_numpy(counts))
    jlab, jmind = j_assign_from_stats(jnp.asarray(f), jnp.asarray(g),
                                      jnp.asarray(counts))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    np.testing.assert_array_equal(lab.numpy(), [0, 1, 0])
    np.testing.assert_allclose(mind.numpy(), np.asarray(jmind))


def test_tiled_never_builds_the_full_block(monkeypatch):
    x, l_idx, u0, c = _problem(n=256, s=0.5)
    n_l, tile = len(l_idx), 64
    orig = ops.kernel_matrix

    def guarded(a, b, **kw):
        assert a.shape[0] * b.shape[0] <= tile * n_l, (a.shape, b.shape)
        return orig(a, b, **kw)

    monkeypatch.setattr(ops, "kernel_matrix", guarded)
    spec = KernelSpec("rbf", gamma=0.3)
    xt = torch.from_numpy(x)
    res = kkmeans_fit(xt, torch.from_numpy(l_idx).long(), spec.diag(xt),
                      torch.from_numpy(u0), spec=spec, n_clusters=c,
                      engine=GramEngine("tiled", tile_rows=tile))
    assert res.n_iter > 1


# ---------------------------------------------------------------------------
# the landmark side as rows of the batch block (GramRows)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1.0, 0.4])
@pytest.mark.parametrize("mode", ["materialize", "tiled"])
def test_g_from_rows_equals_the_contracted_block(mode, s):
    """g taken from f's landmark rows equals g contracted from a K_ll block
    to f32 rounding, at s = 1 and at sorted random landmarks; f and the
    counts are the same computation."""
    x, l_idx, u0, c = _problem(s=s, seed=4)
    spec = KernelSpec("rbf", gamma=0.3)
    eng = GramEngine(mode, tile_rows=64)
    xt, lt, ut = (torch.from_numpy(x), torch.from_numpy(l_idx).long(),
                  torch.from_numpy(u0))
    op_xl = eng.prepare(spec, xt, xt[lt])
    block = eng.prepare(spec, xt[lt], xt[lt])
    got = engine_mod.engine_stats_raw(eng, spec, op_xl, GramRows(op_xl, lt),
                                      ut[lt], ut[lt], c)
    want = engine_mod.engine_stats_raw(eng, spec, op_xl, block, ut[lt],
                                       ut[lt], c)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), rtol=1e-5)


def test_kkmeans_fits_at_s1_match_jax():
    """Every row a landmark: the row views of kkmeans_fit (materialize,
    tiled) and kkmeans_fit_gram / kkmeans_fit_full keep the reference's
    labels and iteration counts."""
    x, l_idx, u0, c = _problem(n=150, s=1.0, seed=5)
    assert np.array_equal(l_idx, np.arange(150))
    for mode in ("materialize", "tiled"):
        got, want = _fit_both(x, l_idx, u0, c, "rbf", mode, "f32")
        _assert_same(got, want)
    spec = JSpec("rbf", gamma=0.3)
    xj = jnp.asarray(x)
    k = np.array(spec(xj, xj))
    diag = np.ones(len(x), np.float32)
    got = kkmeans_fit_gram(torch.from_numpy(k), torch.from_numpy(l_idx).long(),
                           torch.from_numpy(diag), torch.from_numpy(u0),
                           n_clusters=c)
    want = j_kkmeans_fit_full(jnp.asarray(k), jnp.asarray(diag),
                              jnp.asarray(u0), n_clusters=c)
    _assert_same(got, want)
    _assert_same(kkmeans_fit_full(torch.from_numpy(k), torch.from_numpy(diag),
                                  torch.from_numpy(u0), n_clusters=c), want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_matvec_on_a_row_view_is_the_gathered_product(mode, masked):
    """``GramEngine.matvec`` on a GramRows view is its rows of the
    operator's product (masked rows 0), so a caller that contracts the
    landmark side itself still gets K_ll @ H."""
    x, l_idx, u0, c = _problem(s=0.4, seed=6)
    spec = KernelSpec("rbf", gamma=0.3)
    eng = GramEngine(mode, tile_rows=64)
    xt, lt = torch.from_numpy(x), torch.from_numpy(l_idx).long()
    h = torch.nn.functional.one_hot(torch.from_numpy(u0[l_idx]).long(),
                                    c).float()
    op_xl = eng.prepare(spec, xt, xt[lt])
    mask = (lt % 3 != 0).float() if masked else None
    got = eng.matvec(spec, GramRows(op_xl, lt, mask), h)
    want = eng.matvec(spec, op_xl, h)[lt]
    if masked:
        want = want * mask[:, None]
    assert torch.equal(got, want)
    np.testing.assert_allclose(
        got.numpy(), (spec(xt[lt], xt[lt]) @ h
                      * (1.0 if mask is None else mask[:, None])).numpy(),
        rtol=1e-5, atol=1e-5)


class _Shapes(TorchDispatchMode):
    """The shapes of every tensor an op returns while it is open."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.seen.add(tuple(t.shape))
        return out


@pytest.mark.parametrize("fit", ["materialize", "tiled", "gram"])
def test_no_landmark_block_is_built_or_copied(fit):
    """No [|L|, |L|] tensor comes into being in a fit whose landmark side
    is a row view: the materialized fit indexes no landmark block out of
    its batch block, the tiled fit rebuilds none a sweep; and one
    ``obs:g_from_rows`` span runs in every stats pass."""
    x, l_idx, u0, c = _problem(n=200, s=0.4)
    n_l = len(l_idx)
    spec = KernelSpec("rbf", gamma=0.3)
    xt, lt, ut = (torch.from_numpy(x), torch.from_numpy(l_idx).long(),
                  torch.from_numpy(u0))
    k_xl = spec(xt, xt[lt])
    shapes = _Shapes()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof, shapes:
        if fit == "gram":
            res = kkmeans_fit_gram(k_xl, lt, spec.diag(xt), ut, n_clusters=c)
        else:
            res = kkmeans_fit(xt, lt, spec.diag(xt), ut, spec=spec,
                              n_clusters=c, engine=GramEngine(fit, tile_rows=64))
    assert (200, c) in shapes.seen and (n_l, n_l) not in shapes.seen
    names = [e.name for e in prof.events()]
    mode = "tiled" if fit == "tiled" else "materialize"
    assert (names.count("obs:g_from_rows")
            == names.count(f"obs:engine_stats[{mode}]") == res.n_iter + 1)


@pytest.mark.parametrize("mode", MODES)
def test_fused_mode_goes_through_the_kernel_wrappers(monkeypatch, mode):
    """fused assigns through ops.assign_fused and takes its stats through
    ops.gram_matvec, never building a Gram block; the other modes never
    call the fused wrappers."""
    calls = {"kernel_matrix": 0, "assign_fused": 0, "gram_matvec": 0}
    for name in calls:
        orig = getattr(ops, name)

        def spy(*a, _name=name, _orig=orig, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(ops, name, spy)
    x, l_idx, u0, c = _problem()
    spec = KernelSpec("rbf", gamma=0.3)
    xt = torch.from_numpy(x)
    res = kkmeans_fit(xt, torch.from_numpy(l_idx).long(), spec.diag(xt),
                      torch.from_numpy(u0), spec=spec, n_clusters=c,
                      engine=GramEngine(mode))
    if mode == "fused":
        assert calls["assign_fused"] == res.n_iter + 1
        assert calls["gram_matvec"] == res.n_iter + 1
        assert calls["kernel_matrix"] == 0
    else:
        assert calls["assign_fused"] == calls["gram_matvec"] == 0
        assert calls["kernel_matrix"] > 0


def test_engine_config():
    with pytest.raises(ValueError):
        GramEngine("resident")
    with pytest.raises(ValueError):
        GramEngine("tiled", tile_rows=0)
    with pytest.raises(ValueError):
        GramEngine("fused", precision="fp8")
    eng = resolve_engine("fused", "bf16")
    assert eng == GramEngine("fused", precision="bf16")
    assert resolve_engine(eng) is eng
    with pytest.raises(ValueError):
        resolve_engine(3)
    assert engine_mod.ENGINE_MODES == ("materialize", "fused", "tiled")


# ---------------------------------------------------------------------------
# KernelSpec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_kernel_spec_matches_jax(kind):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(30, 7)).astype(np.float32)
    y = rng.normal(size=(11, 7)).astype(np.float32)
    spec_t = KernelSpec(kind, gamma=0.2, coef0=0.5, degree=3)
    spec_j = JSpec(kind, gamma=0.2, coef0=0.5, degree=3)
    xt, yt, xj, yj = (torch.from_numpy(x), torch.from_numpy(y),
                      jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(spec_t(xt, yt).numpy(), np.asarray(spec_j(xj, yj)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(spec_t.diag(xt).numpy(), np.asarray(spec_j.diag(xj)),
                               rtol=1e-5, atol=1e-5)
    # row pairs: the reference's vmap of 1x1 Gram blocks
    want = jax.vmap(lambda a, b: spec_j(a[None], b[None])[0, 0])(xj[:11], yj)
    np.testing.assert_allclose(spec_t.paired(xt[:11], yt).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def test_kernel_spec_rejects_unknown_kind():
    with pytest.raises(ValueError):
        KernelSpec("sigmoid")


def test_gamma_from_dmax_matches_jax():
    x = np.random.default_rng(9).random((500, 784)).astype(np.float32)
    got = gamma_from_dmax(torch.from_numpy(x))
    want = j_gamma_from_dmax(jnp.asarray(x))
    assert got == pytest.approx(want, rel=1e-6)
