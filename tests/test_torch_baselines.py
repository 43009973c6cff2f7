"""Parity of the port's linear baselines (``repro_torch.baselines``: Lloyd
with k-means++ seeding, Sculley's SGD mini-batch k-means) with the JAX
package's, on the CPU.

JAX and torch draw different numbers from one seed, so Lloyd is compared
with the reference's own k-means++ centers injected (its ``_pp_init`` with
the same key). Sculley draws its init rows and batches from numpy in both
packages, so it is compared with no injection.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.baselines.lloyd as j_lloyd
from repro.baselines.sculley import sgd_minibatch_kmeans as j_sculley
from repro.core.metrics import clustering_accuracy as j_acc
from repro_torch.baselines import lloyd, lloyd_kmeans, sgd_minibatch_kmeans
from repro_torch.core.metrics import clustering_accuracy, nmi

from conftest import four_blobs


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _j_pp(x, seed, c):
    return np.array(j_lloyd._pp_init(jnp.asarray(x), jax.random.PRNGKey(seed),
                                       c))


def _j_lloyd_from(x, centers0, max_iters=300):
    """The reference's ``_fit_once`` body run eagerly from given centers."""
    orig = j_lloyd._pp_init
    j_lloyd._pp_init = lambda *_: jnp.asarray(centers0)
    try:
        return j_lloyd._fit_once.__wrapped__(
            jnp.asarray(x), jax.random.PRNGKey(0),
            n_clusters=centers0.shape[0], max_iters=max_iters)
    finally:
        j_lloyd._pp_init = orig


def _inject_reference_pp(monkeypatch, x):
    """Make the port's k-means++ return the reference's draw for the same
    seed (the generator's seed is the reference's PRNGKey)."""
    def pp(xt, gen, c):
        return torch.as_tensor(_j_pp(x, gen.initial_seed(), c))
    monkeypatch.setattr(lloyd, "_pp_init", pp)


def _check_equal(res, ref):
    np.testing.assert_array_equal(res.labels.numpy(), np.asarray(ref.labels))
    assert _rel(res.centers.numpy(), ref.centers) <= 1e-5
    assert abs(float(res.cost) - float(ref.cost)) <= 1e-5 * abs(float(ref.cost))
    assert res.n_iter == int(ref.n_iter)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lloyd_from_reference_seeds_matches(seed):
    x, _ = four_blobs(n_per=150, seed=20 + seed)
    c0 = _j_pp(x, seed, 4)
    res = lloyd._lloyd(torch.as_tensor(x), torch.as_tensor(c0), max_iters=300)
    _check_equal(res, _j_lloyd_from(x, c0))


def test_lloyd_n_init_keeps_lowest_cost(monkeypatch):
    x, _ = four_blobs(n_per=100, seed=12)
    # 6 clusters on 4 blobs: restarts land on different local minima
    _inject_reference_pp(monkeypatch, x)
    res = lloyd_kmeans(x, 6, n_init=5, seed=5, device="cpu")
    ref = j_lloyd.kmeans(x, 6, n_init=5, seed=5)
    _check_equal(res, ref)
    costs = [float(lloyd._fit_once(torch.as_tensor(x), 5 + i, n_clusters=6,
                                   max_iters=300).cost) for i in range(5)]
    assert float(res.cost) == min(costs)
    assert costs.index(min(costs)) == next(
        i for i, c in enumerate(costs) if c == float(res.cost))


def test_lloyd_all_zero_distances_draw_uniform():
    """Duplicated rows: every distance is 0 after the first pick, so the
    draw falls back to uniform; the fit is exact with cost 0."""
    x = np.tile(np.array([[0.5, -1.0, 2.0]], np.float32), (30, 1))
    res = lloyd_kmeans(x, 3, n_init=2, seed=0, device="cpu")
    ref = j_lloyd.kmeans(x, 3, n_init=2, seed=0)
    np.testing.assert_array_equal(res.centers.numpy(), np.tile(x[:1], (3, 1)))
    np.testing.assert_array_equal(res.labels.numpy(), np.zeros(30, np.int32))
    np.testing.assert_array_equal(res.labels.numpy(), np.asarray(ref.labels))
    assert float(res.cost) == 0.0 == float(ref.cost)


def test_lloyd_two_distinct_rows_three_clusters():
    """Two distinct rows, three clusters: the third pick is uniform over
    rows at distance 0, one center duplicates, ties go to the lowest index."""
    x = np.concatenate([np.zeros((10, 2)), np.ones((10, 2))]).astype(np.float32)
    c0 = _j_pp(x, 3, 3)
    res = lloyd._lloyd(torch.as_tensor(x), torch.as_tensor(c0), max_iters=50)
    _check_equal(res, _j_lloyd_from(x, c0, 50))
    assert float(res.cost) == 0.0
    port = lloyd_kmeans(x, 3, n_init=1, seed=3, device="cpu")
    assert float(port.cost) == 0.0
    assert len(np.unique(port.labels.numpy())) == 2


def test_lloyd_empty_cluster_keeps_its_center():
    x, _ = four_blobs(n_per=50, seed=3)
    c0 = np.concatenate([x[:3], [[50.0, 50.0]]]).astype(np.float32)
    res = lloyd._lloyd(torch.as_tensor(x), torch.as_tensor(c0), max_iters=300)
    _check_equal(res, _j_lloyd_from(x, c0))
    np.testing.assert_array_equal(res.centers[3].numpy(), c0[3])
    assert not (res.labels.numpy() == 3).any()


def test_lloyd_counts_host_reads():
    x, _ = four_blobs(n_per=50, seed=4)
    lloyd.HOST_READS["lloyd"] = 0
    res = lloyd_kmeans(x, 4, n_init=2, seed=0, device="cpu")
    runs = [lloyd._fit_once(torch.as_tensor(x), i, n_clusters=4,
                            max_iters=300).n_iter for i in range(2)]
    # one `changed` read an iteration, one cost comparison a later restart
    assert res.n_iter in runs
    lloyd.HOST_READS["lloyd"] = 0
    lloyd_kmeans(x, 4, n_init=2, seed=0, device="cpu")
    assert lloyd.HOST_READS["lloyd"] == sum(runs) + 1


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("batch_size,n_iters", [(100, 30), (37, 12)])
def test_sculley_matches_reference(seed, batch_size, n_iters):
    x, _ = four_blobs(n_per=120, seed=30 + seed)
    res = sgd_minibatch_kmeans(x, 4, batch_size=batch_size, n_iters=n_iters,
                               seed=seed, device="cpu")
    ref = j_sculley(x, 4, batch_size=batch_size, n_iters=n_iters, seed=seed)
    assert _rel(res.centers.numpy(), ref.centers) <= 1e-5
    np.testing.assert_array_equal(res.labels.numpy(), np.asarray(ref.labels))
    assert abs(float(res.cost) - float(ref.cost)) <= 1e-5 * float(ref.cost)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    x, _ = four_blobs(n_per=10, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lloyd_kmeans(x, 2, n_init=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sgd_minibatch_kmeans(x, 2, batch_size=10, n_iters=1)


def _lloyd_recovers_blobs():
    x, y = four_blobs(n_per=250, seed=11)
    res = lloyd_kmeans(x, 4, n_init=3, seed=0, device="cpu")
    ref = j_lloyd.kmeans(x, 4, n_init=3, seed=0)
    acc = clustering_accuracy(y, res.labels.numpy())
    assert acc > 0.98 and float(res.cost) > 0
    assert abs(acc - j_acc(y, np.asarray(ref.labels))) <= 0.02
    assert nmi(y, res.labels.numpy()) > 0.9


def _lloyd_cost_decreases_with_restarts():
    x, _ = four_blobs(n_per=100, seed=12)
    c1 = float(lloyd_kmeans(x, 4, n_init=1, seed=5, device="cpu").cost)
    c5 = float(lloyd_kmeans(x, 4, n_init=5, seed=5, device="cpu").cost)
    assert c5 <= c1 + 1e-6


def _sculley_sgd_runs_and_clusters():
    x, y = four_blobs(n_per=250, seed=13)
    accs, j_accs = [], []
    for s in (0, 1, 2):
        labels = sgd_minibatch_kmeans(x, 4, batch_size=100, n_iters=100,
                                      seed=s, device="cpu").labels.numpy()
        accs.append(clustering_accuracy(y, labels))
        j_accs.append(j_acc(y, np.asarray(
            j_sculley(x, 4, batch_size=100, n_iters=100, seed=s).labels)))
    assert max(accs) > 0.95
    np.testing.assert_allclose(accs, j_accs, atol=1e-12)


@pytest.mark.parametrize("case", [_lloyd_recovers_blobs,
                                  _lloyd_cost_decreases_with_restarts,
                                  _sculley_sgd_runs_and_clusters],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_reference_baseline_cases(case):
    """The reference's ``test_baselines_metrics.py`` Lloyd and Sculley
    cases, run on the port and held to the reference's numbers."""
    case()
