"""Parity of the port's outer loop (``repro_torch.core.minibatch``, paper
Alg.1) with the JAX package's, on the CPU.

The two packages draw different random numbers from the same seed, so the
batch steps are compared with the JAX package's own landmark and k-means++
draws injected into the port (equal labels, medoids and cardinalities), a
batch step resumes from a JAX ``GlobalState`` carried over by
``repro_torch.convert``, and whole fits are held by accuracy and NMI: the
mean over seeds within 0.02 of the JAX fit's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KernelSpec as JSpec
from repro.core import MiniBatchConfig as JConfig
from repro.core import fit_dataset as j_fit_dataset
from repro.core.init import kmeans_pp_indices as j_kmeans_pp
from repro.core.kkmeans import medoid_indices as j_medoid_indices
from repro.core.landmarks import num_landmarks as j_num_landmarks
from repro.core.landmarks import select_landmark_indices as j_select
from repro.core.metrics import clustering_accuracy as j_acc
from repro.core.metrics import nmi as j_nmi
from repro.core.minibatch import GlobalState as JState
from repro.core.minibatch import _first_batch_step as j_first_step
from repro.core.minibatch import _next_batch_step as j_next_step
from repro.core.minibatch import predict as j_predict
from repro.data import sampling as j_sampling
from repro.data import synthetic as j_synthetic
from repro_torch import convert
from repro_torch.approx.selectors import KPPSelector
from repro_torch.core import (KernelSpec, MiniBatchConfig, clustering_accuracy,
                              fit, fit_dataset, nmi)
from repro_torch.core.kkmeans import medoid_indices
from repro_torch.core.landmarks import num_landmarks
from repro_torch.core.minibatch import (_first_batch_step, _next_batch_step,
                                        batch_generator, draw_first, predict)
from repro_torch.data import sampling, synthetic

SPEC_ARGS = dict(name="rbf", gamma=2.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine, some of them
    simulating 8-device JAX meshes whose collectives time out when
    starved: keep torch's CPU ops (small here) on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(**kw):
    base = dict(n_clusters=4, n_batches=3, s=0.5, seed=0)
    base.update(kw)
    return (MiniBatchConfig(kernel=KernelSpec(**SPEC_ARGS), **base),
            JConfig(kernel=JSpec(**SPEC_ARGS), **base))


def _batches():
    x, _ = synthetic.make_blobs(600, 5, 4, sep=3.0, seed=1)
    return sampling.split_batches(x, 3)


def _jax_first(b0, cfg_j):
    """The JAX first step and the draws it made (same key schedule)."""
    key = jax.random.fold_in(jax.random.PRNGKey(cfg_j.seed), 0)
    n_l = j_num_landmarks(len(b0), cfg_j.s, n_clusters=cfg_j.n_clusters)
    xj = jnp.asarray(b0)
    state, res = j_first_step(xj, key, cfg=cfg_j, n_landmarks=n_l)
    k_lm, k_pp = jax.random.split(key)
    l_idx = j_select(k_lm, xj, n_l, cfg_j.kernel)
    seeds = j_kmeans_pp(xj, cfg_j.kernel.diag(xj), k_pp,
                        n_clusters=cfg_j.n_clusters, spec=cfg_j.kernel)
    return state, res, np.array(l_idx), np.array(seeds)


def _jax_next(b1, state, cfg_j, i=1):
    key = jax.random.fold_in(jax.random.PRNGKey(cfg_j.seed), i)
    n_l = j_num_landmarks(len(b1), cfg_j.s, n_clusters=cfg_j.n_clusters)
    xj = jnp.asarray(b1)
    new_state, res, disp = j_next_step(xj, key, state, cfg=cfg_j,
                                       n_landmarks=n_l)
    l_idx = j_select(jax.random.split(key)[0], xj, n_l, cfg_j.kernel)
    return new_state, res, disp, np.array(l_idx)


def _port_state(state_j):
    return convert.global_state_from_numpy(
        np.array(state_j.medoids), np.array(state_j.medoid_diag),
        np.array(state_j.cardinalities), int(state_j.batches_done), "cpu")


@pytest.mark.parametrize("engine", ["materialize", "fused"])
def test_first_batch_step_with_jax_draws(engine):
    cfg_t, cfg_j = _configs(engine=engine)
    b0 = _batches()[0]
    state_j, res_j, l_idx, seeds = _jax_first(b0, cfg_j)
    x = torch.from_numpy(b0)
    state_t, res_t = _first_batch_step(x, torch.from_numpy(l_idx).long(),
                                       torch.from_numpy(seeds).long(),
                                       cfg=cfg_t)
    np.testing.assert_array_equal(res_t.labels.numpy(), np.asarray(res_j.labels))
    assert res_t.n_iter == int(res_j.n_iter)
    m_t = medoid_indices(cfg_t.kernel.diag(x), res_t.f, res_t.labels,
                         res_t.counts)
    m_j = j_medoid_indices(cfg_j.kernel.diag(jnp.asarray(b0)), res_j.f,
                           res_j.labels, res_j.counts)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(state_t.medoids.numpy(),
                                  np.asarray(state_j.medoids))
    np.testing.assert_array_equal(state_t.cardinalities.numpy(),
                                  np.asarray(state_j.cardinalities))
    assert state_t.batches_done == int(state_j.batches_done) == 1


@pytest.mark.parametrize("engine", ["materialize", "fused"])
def test_next_batch_step_resumed_from_jax_state(engine):
    cfg_t, cfg_j = _configs(engine=engine)
    b0, b1, _ = _batches()
    state_j, _, _, _ = _jax_first(b0, cfg_j)
    new_j, res_j, disp_j, l_idx = _jax_next(b1, state_j, cfg_j)
    new_t, res_t, disp_t = _next_batch_step(
        torch.from_numpy(b1), torch.from_numpy(l_idx).long(),
        _port_state(state_j), cfg=cfg_t)
    np.testing.assert_array_equal(res_t.labels.numpy(), np.asarray(res_j.labels))
    np.testing.assert_array_equal(new_t.medoids.numpy(),
                                  np.asarray(new_j.medoids))
    np.testing.assert_array_equal(new_t.cardinalities.numpy(),
                                  np.asarray(new_j.cardinalities))
    np.testing.assert_allclose(disp_t.numpy(), np.asarray(disp_j), atol=1e-5)
    assert new_t.batches_done == int(new_j.batches_done) == 2


def test_empty_batch_cluster_keeps_its_global_medoid():
    """A global medoid far from every row gets no batch member (a = 0):
    both packages keep it verbatim and add nothing to its cardinality."""
    cfg_t, cfg_j = _configs(n_clusters=5)
    b0, b1, _ = _batches()
    state_j, _, _, _ = _jax_first(b0, _configs(n_clusters=4)[1])
    far = np.full((1, b0.shape[1]), 50.0, np.float32)
    state_j = JState(
        medoids=jnp.concatenate([state_j.medoids, jnp.asarray(far)]),
        medoid_diag=jnp.ones((5,), jnp.float32),
        cardinalities=jnp.concatenate([state_j.cardinalities,
                                       jnp.array([7.0])]),
        batches_done=state_j.batches_done)
    new_j, res_j, _, l_idx = _jax_next(b1, state_j, cfg_j)
    new_t, res_t, _ = _next_batch_step(
        torch.from_numpy(b1), torch.from_numpy(l_idx).long(),
        _port_state(state_j), cfg=cfg_t)
    assert float(res_t.counts[4]) == 0.0 == float(res_j.counts[4])
    np.testing.assert_array_equal(new_t.medoids[4].numpy(), far[0])
    np.testing.assert_array_equal(new_t.medoids.numpy(),
                                  np.asarray(new_j.medoids))
    np.testing.assert_array_equal(new_t.cardinalities.numpy(),
                                  np.asarray(new_j.cardinalities))


def test_state_conversion_round_trip():
    medoids = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    st = convert.global_state_from_numpy(medoids, np.ones(3), [2, 0, 5], 4,
                                         "cpu")
    back = convert.state_to_numpy(st)
    np.testing.assert_array_equal(back["medoids"], medoids)
    np.testing.assert_array_equal(back["cardinalities"], [2.0, 0.0, 5.0])
    assert back["batches_done"] == 4 and st.medoids.dtype == torch.float32


# ---------------------------------------------------------------------------
# exact copies: landmark counts, batch indices, metrics, datasets
# ---------------------------------------------------------------------------


def test_num_landmarks_matches_jax_over_a_sweep():
    cases = 0
    for n in (3, 10, 97, 100, 1000, 15000):
        for s in (0.01, 0.1, 0.2, 1 / 3, 0.5, 0.999, 1.0, 0.0, 1.5):
            for c in (1, 4, 10, 120):
                for mult in (1, 3, 8, 64):
                    try:
                        want = j_num_landmarks(n, s, n_clusters=c,
                                               multiple_of=mult)
                    except ValueError:
                        with pytest.raises(ValueError):
                            num_landmarks(n, s, n_clusters=c, multiple_of=mult)
                        continue
                    assert num_landmarks(n, s, n_clusters=c,
                                         multiple_of=mult) == want
                    cases += 1
    assert cases > 300


def test_batch_indices_match_jax_over_a_sweep():
    for n in (1, 10, 11, 97, 600):
        for b in (1, 2, 3, 7, 600, 601):
            for strategy in ("stride", "block", "random"):
                try:
                    want = j_sampling.batch_indices(n, b, strategy)
                except ValueError:
                    with pytest.raises(ValueError):
                        sampling.batch_indices(n, b, strategy)
                    continue
                got = sampling.batch_indices(n, b, strategy)
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    for g, w in zip(sampling.split_batches(x, 3),
                    j_sampling.split_batches(x, 3)):
        np.testing.assert_array_equal(g, w)


def test_metrics_and_datasets_match_jax():
    rng = np.random.default_rng(3)
    y, u = rng.integers(0, 5, 300), rng.integers(0, 7, 300)
    assert clustering_accuracy(y, u) == j_acc(y, u)
    assert nmi(y, u) == j_nmi(y, u)
    for port, ref, args in [(synthetic.toy2d, j_synthetic.toy2d, (50,)),
                            (synthetic.make_blobs, j_synthetic.make_blobs,
                             (200, 6, 3)),
                            (synthetic.make_mnist_like,
                             j_synthetic.make_mnist_like, (300,))]:
        (xa, ya), (xb, yb) = port(*args, seed=4), ref(*args, seed=4)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


# ---------------------------------------------------------------------------
# whole fits
# ---------------------------------------------------------------------------


def xor_blobs(n_per=500, seed=0):
    """examples/quickstart.py's XOR arrangement (degree-2 kernel win)."""
    rng = np.random.default_rng(seed)
    c = np.array([[2, 2], [-2, -2], [2, -2], [-2, 2]], np.float32)
    x = np.concatenate([rng.normal(ci, 0.5, (n_per, 2)) for ci in c])
    y = np.array([0] * n_per * 2 + [1] * n_per * 2, np.int32)
    perm = rng.permutation(len(x))
    return x[perm].astype(np.float32), y[perm]


def _scores(x, y, spec_kw, seeds, **cfg_kw):
    port, ref = [], []
    for seed in seeds:
        res = fit_dataset(x, MiniBatchConfig(kernel=KernelSpec(**spec_kw),
                                             seed=seed, **cfg_kw),
                          device="cpu")
        lab = res.predict(x).numpy()
        port.append((clustering_accuracy(y, lab), nmi(y, lab)))
        spec_j = JSpec(**spec_kw)
        res_j = j_fit_dataset(x, JConfig(kernel=spec_j, seed=seed, **cfg_kw))
        lab_j = np.asarray(j_predict(jnp.asarray(x), res_j.state.medoids,
                                     res_j.state.medoid_diag, spec=spec_j))
        ref.append((j_acc(y, lab_j), j_nmi(y, lab_j)))
    return np.mean(port, axis=0), np.mean(ref, axis=0)


@pytest.mark.parametrize("s,seeds", [(1.0, (0,)), (0.2, (0, 1, 2))])
def test_fit_dataset_toy2d_matches_jax(s, seeds):
    """At s = 1 every row is a landmark and the draws barely matter; at
    s = 0.2 the landmark draws move single fits by a few points, so the
    means over three seeds are compared."""
    x, y = synthetic.toy2d(500)
    port, ref = _scores(x, y, dict(name="rbf", gamma=4.0), seeds,
                        n_clusters=4, n_batches=3, s=s)
    np.testing.assert_allclose(port, ref, atol=0.02)
    assert port[0] > 0.75


def test_fit_dataset_xor_poly2_matches_jax():
    x, y = xor_blobs()
    port, ref = _scores(x, y, dict(name="polynomial", gamma=0.25, coef0=0.0,
                                   degree=2), (0,), n_clusters=2, n_batches=1,
                        s=1.0)
    np.testing.assert_allclose(port, ref, atol=0.02)
    assert port[0] > 0.95


def test_resumed_fit_equals_uninterrupted():
    """Batch i's draws depend on (seed, i) alone, so a fit resumed from the
    state after batch 0 ends where the uninterrupted fit ends."""
    cfg, _ = _configs()
    batches = _batches()
    saved = {}
    full = fit(batches, cfg, device="cpu",
               checkpoint_cb=lambda st, i: saved.setdefault(i, st))
    resumed = fit(batches[1:], cfg, state=saved[0], device="cpu")
    np.testing.assert_array_equal(resumed.state.medoids.numpy(),
                                  full.state.medoids.numpy())
    np.testing.assert_array_equal(resumed.state.cardinalities.numpy(),
                                  full.state.cardinalities.numpy())
    assert resumed.state.batches_done == full.state.batches_done == 3
    assert int(full.state.cardinalities.sum()) == sum(
        num_landmarks(len(b), cfg.s, n_clusters=4) for b in batches)
    assert [h.inner_iters for h in resumed.history] == [
        h.inner_iters for h in full.history[1:]]


def test_batch_draws_are_pure_in_seed_and_index():
    x = torch.from_numpy(_batches()[0])
    cfg, _ = _configs()
    a = draw_first(x, batch_generator(0, 5), cfg=cfg, n_landmarks=150)
    b = draw_first(x, batch_generator(0, 5), cfg=cfg, n_landmarks=150)
    c = draw_first(x, batch_generator(0, 6), cfg=cfg, n_landmarks=150)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert len(torch.unique(a[1])) == cfg.n_clusters
    assert bool(torch.all(a[0][1:] > a[0][:-1]))          # sorted, distinct


def test_predict_labels_by_nearest_medoid():
    cfg, _ = _configs(engine="tiled")
    x = np.concatenate(_batches())
    res = fit_dataset(x, cfg, device="cpu")
    lab = res.predict(x)
    assert lab.dtype == torch.int32 and lab.shape == (len(x),)
    torch.testing.assert_close(
        lab, predict(x, res.state.medoids, res.state.medoid_diag,
                     spec=cfg.kernel, device="cpu"))
    assert len(res.history) == 3 and res.history[0].displacement.shape == (4,)


def test_config_rejects_what_this_slice_does_not_port():
    # CSR batches: the sketch methods take them, the exact method refuses
    cfg = MiniBatchConfig(n_clusters=2, method="sketch",
                          kernel=KernelSpec("linear"))
    eye = torch.eye(4).to_sparse_csr()
    assert fit_dataset(eye, cfg, device="cpu").state.batches_done == 1
    with pytest.raises(ValueError, match="exact.*CSRBatch"):
        fit_dataset(eye, MiniBatchConfig(n_clusters=2), device="cpu")
    with pytest.raises(ValueError):
        MiniBatchConfig(n_clusters=2, method="pca")
    # the leverage-aware selectors are ported: names and instances pass
    assert MiniBatchConfig(n_clusters=2, selector="rls").selector == "rls"
    MiniBatchConfig(n_clusters=2, selector=KPPSelector())
    with pytest.raises(ValueError):
        MiniBatchConfig(n_clusters=2, selector="leverage")
    with pytest.raises(ValueError):
        MiniBatchConfig(n_clusters=2, engine="resident")
    with pytest.raises(ValueError):
        MiniBatchConfig(n_clusters=2, precision="fp8")
    with pytest.raises(ValueError, match="empty"):
        fit([], MiniBatchConfig(n_clusters=2), device="cpu")
