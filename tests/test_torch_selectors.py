"""The port's landmark selectors (``repro_torch.approx.selectors``) against
the JAX package's (``repro.approx.selectors``) on seeded numpy inputs.

Threefry keys do not cross the port, so the parity tests hand the port's
selection steps the reference's own per-row draws (pilot priorities and
Gumbel noise for RLS; the first seed and each step's categorical
candidates for k-means++) and require equal indices. Tolerances:
``rls_scores`` and the pilot whitening (compared as W W^T, which no
eigenvector sign or order changes) within 1e-4 relative, normwise; fits
within 0.02 NMI of the reference's, at NMI >= 0.9.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import four_blobs
from repro.approx import selectors as jsel
from repro.core import KernelSpec as JSpec
from repro.core import MiniBatchConfig as JConfig
from repro.core import fit_dataset as j_fit_dataset
from repro.core.init import kmeans_pp_indices as j_kmeans_pp
from repro.core.landmarks import choose_landmarks as j_choose
from repro.core.metrics import nmi as j_nmi
from repro_torch.approx import make_feature_map, make_nystrom, selectors
from repro_torch.core import (KernelSpec, MiniBatchConfig, fit, fit_dataset,
                              kmeans_pp_indices, nmi)
from repro_torch.core.landmarks import choose_landmarks
from repro_torch.data.sampling import split_batches

SPEC = dict(name="rbf", gamma=0.4)


def _data(n=400, d=6, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# the keyed draw
# ---------------------------------------------------------------------------


def _splitmix_py(z):
    m = (1 << 64) - 1
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
    return z ^ (z >> 31)


@pytest.mark.parametrize("key", [0, 7, (1 << 62) - 1])
@pytest.mark.parametrize("tag", [0, 1, 2])
def test_keyed_uniform_is_splitmix64_in_python_integers(key, tag):
    """The int64 tensor arithmetic (wrapping multiplies, logical shifts)
    equals splitmix64 computed in Python's unbounded integers, bitwise."""
    m, golden = (1 << 64) - 1, 0x9E3779B97F4A7C15
    gids = np.array([0, 1, 2, 99, 12345, 2 ** 31 + 5], np.int64)
    base = _splitmix_py((key + (tag + 1) * golden) & m)
    want = [((_splitmix_py((base + (int(g) + 1) * golden) & m) >> 40) + 0.5)
            / (1 << 24) for g in gids]
    got = selectors.keyed_uniform(key, tag, torch.from_numpy(gids))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.float32(want))
    assert bool(((got > 0) & (got < 1)).all())


def test_keyed_draws_are_pure_and_tagged():
    gids = torch.arange(1000)
    a = selectors.keyed_uniform(5, 1, gids)
    assert torch.equal(a, selectors.keyed_uniform(5, 1, gids))
    assert torch.equal(a[500:], selectors.keyed_uniform(5, 1, gids[500:]))
    assert not torch.equal(a, selectors.keyed_uniform(5, 2, gids))
    assert not torch.equal(a, selectors.keyed_uniform(6, 1, gids))
    # roughly uniform: mean 1/2, and Gumbel noise has mean ~0.577
    assert abs(float(a.mean()) - 0.5) < 0.03
    g = selectors.keyed_gumbel(5, 2, torch.arange(20000))
    assert abs(float(g.mean()) - 0.5772) < 0.03


# ---------------------------------------------------------------------------
# RLS pieces against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m,delta", [(200, 12, 1e-2), (333, 40, 1e-3)])
def test_rls_scores_match_jax(n, m, delta):
    rng = np.random.default_rng(n)
    c = rng.normal(size=(n, m)).astype(np.float32)
    diag = (1.0 + rng.random(n)).astype(np.float32) * m
    g = c.T @ c
    want = jsel.rls_scores(jnp.asarray(c), jnp.asarray(diag), jnp.asarray(g),
                           delta=delta)
    got = selectors.rls_scores(torch.from_numpy(c), torch.from_numpy(diag),
                               torch.from_numpy(g), delta=delta)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("name,kw", [("rbf", dict(gamma=0.3)),
                                     ("polynomial", dict(gamma=0.2,
                                                         degree=2)),
                                     ("linear", {})])
def test_pilot_whitening_matches_jax(name, kw):
    pilot = _data(16, 24, seed=3)
    wj = np.asarray(jsel.pilot_whitening(jnp.asarray(pilot), JSpec(name, **kw)),
                    np.float64)
    wt = selectors.pilot_whitening(torch.from_numpy(pilot),
                                   KernelSpec(name, **kw)).double().numpy()
    assert _rel(wt @ wt.T, wj @ wj.T) <= 1e-4


def _jax_rls_draws(key, n):
    gids = jnp.arange(n, dtype=jnp.int32)
    pri = jsel._per_gid_uniform(jax.random.fold_in(key, jsel._TAG_PILOT),
                                gids)
    noise = jsel._per_gid_gumbel(jax.random.fold_in(key, jsel._TAG_SELECT),
                                 gids)
    return torch.tensor(np.asarray(pri)), torch.tensor(np.asarray(noise))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,m", [(400, 24), (250, 40)])
def test_rls_selection_from_injected_jax_draws(seed, n, m):
    x = _data(n, 6, seed=seed)
    key = jax.random.PRNGKey(seed)
    spec_j, spec_t = JSpec(**SPEC), KernelSpec(**SPEC)
    sel_j = jsel.RLSSelector()
    want = np.asarray(sel_j.select_indices(key, jnp.asarray(x), m, spec_j))
    pri, noise = _jax_rls_draws(key, n)
    sel = selectors.RLSSelector()
    xt = torch.from_numpy(x)
    pidx = sel.pilot_indices(pri, m)
    np.testing.assert_array_equal(
        pidx.numpy(), np.asarray(sel_j.pilot_indices(
            key, jnp.arange(n, dtype=jnp.int32), m)))
    scores = sel.scores(xt, pidx, spec_t)
    want_scores = sel_j.scores(key, jnp.asarray(x),
                               jnp.arange(n, dtype=jnp.int32), m, spec_j)
    assert _rel(scores, want_scores) <= 1e-4
    got = sel.gumbel_top_m(scores, noise, m)
    np.testing.assert_array_equal(got.numpy(), want)


class _JaxKppDraws:
    """The reference k-means++'s draws (``repro/core/init.py``): the first
    seed from a split key, then jax.random.categorical per step."""

    def __init__(self, key, n_clusters):
        key, self.sub = jax.random.split(key)
        self.keys = jax.random.split(key, n_clusters - 1)
        self.t = 0

    def first(self, n):
        return int(jax.random.randint(self.sub, (), 0, n, dtype=jnp.int32))

    def candidates(self, mind2, n_cand):
        mind2 = jnp.asarray(mind2.numpy())
        logp = jnp.where(mind2 > 0, jnp.log(jnp.maximum(mind2, 1e-30)),
                         -jnp.inf)
        logp = jnp.where(jnp.all(~jnp.isfinite(logp)), jnp.zeros_like(logp),
                         logp)
        c = jax.random.categorical(self.keys[self.t], logp, shape=(n_cand,))
        self.t += 1
        return torch.from_numpy(np.asarray(c, np.int64))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("m", [5, 16])
def test_kpp_selection_from_injected_jax_draws(seed, m):
    x = _data(300, 4, seed=seed)
    key = jax.random.PRNGKey(seed)
    spec_j, spec_t = JSpec(**SPEC), KernelSpec(**SPEC)
    want = np.asarray(jsel.KPPSelector().select_indices(
        key, jnp.asarray(x), m, spec_j))
    xt = torch.from_numpy(x)
    draws = _JaxKppDraws(jax.random.fold_in(key, jsel._TAG_SELECT), m)
    got = torch.sort(kmeans_pp_indices(xt, spec_t.diag(xt), draws,
                                       n_clusters=m, spec=spec_t)).values
    np.testing.assert_array_equal(got.numpy(), want)
    # and the reference's own k-means++ picks the same seeds from that key
    np.testing.assert_array_equal(want, np.sort(np.asarray(j_kmeans_pp(
        jnp.asarray(x), spec_j.diag(jnp.asarray(x)),
        jax.random.fold_in(key, jsel._TAG_SELECT), n_clusters=m,
        spec=spec_j))))


def test_uniform_keeps_the_historical_draw():
    """Given a generator, uniform draws exactly choose_landmarks(gen, ...)
    (so uniform fits do not move), as the reference's uniform is its
    choose_landmarks; an integer key seeds a generator."""
    x = _data(120, 3)
    xt = torch.from_numpy(x)
    sel = selectors.resolve("uniform")
    got = sel.select_indices(torch.Generator().manual_seed(4), xt, 16,
                             KernelSpec(**SPEC))
    want = choose_landmarks(torch.Generator().manual_seed(4), 120, 16)
    assert torch.equal(got, want)
    key = jax.random.PRNGKey(1)
    np.testing.assert_array_equal(
        np.asarray(jsel.resolve("uniform").select_indices(
            key, jnp.asarray(x), 16, JSpec(**SPEC))),
        np.asarray(j_choose(key, 120, 16)))
    assert torch.equal(sel.select_indices(9, xt, 16, KernelSpec(**SPEC)),
                       choose_landmarks(torch.Generator().manual_seed(9),
                                        120, 16))


# ---------------------------------------------------------------------------
# determinism, streaming, resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", selectors.NAMES)
def test_same_key_same_landmarks(name):
    x = torch.from_numpy(_data())
    sel = selectors.resolve(name)
    spec = KernelSpec(**SPEC)
    a = sel.select_indices(3, x, 24, spec)
    assert torch.equal(a, sel.select_indices(3, x, 24, spec))
    assert len(torch.unique(a)) == 24 and bool((a[1:] > a[:-1]).all())
    assert not torch.equal(a, sel.select_indices(4, x, 24, spec))


@pytest.mark.parametrize("name", selectors.NAMES)
@pytest.mark.parametrize("pool", [8192, 128])
def test_streaming_is_chunking_invariant(name, pool):
    """3 chunks against 5: bitwise the same pool and landmarks; within the
    pool they equal the offline selection."""
    x = _data(300)
    sel = dataclasses.replace(selectors.resolve(name), pool=pool)
    spec = KernelSpec(**SPEC)
    lm3, st3 = selectors.select_streaming(sel, 11, np.array_split(x, 3), 16,
                                          spec, device="cpu")
    lm5, st5 = selectors.select_streaming(sel, 11, np.array_split(x, 5), 16,
                                          spec, device="cpu")
    assert torch.equal(lm3, lm5) and torch.equal(st3.gids, st5.gids)
    assert int(st3.rows_seen) == 300 and int(st5.folds) == 5
    assert st3.rows.shape[0] == min(pool, 300)
    if pool >= 300:
        assert torch.equal(lm3, sel.select(11, torch.from_numpy(x), 16,
                                           spec))


@pytest.mark.parametrize("name", selectors.NAMES)
def test_streaming_resumes_from_a_copied_state(name):
    """Fold two of five chunks, copy the state (as a checkpoint would),
    resume from the copy: the landmarks equal the uninterrupted fold's."""
    x = _data(360, 5)
    batches = np.array_split(x, 5)
    spec = KernelSpec(**SPEC)
    saved = {}

    def cb(state, i):
        saved[i] = selectors.SelectorState(*(t.clone() for t in state))

    straight, _ = selectors.select_streaming(name, 9, batches, 18, spec,
                                             checkpoint_cb=cb, device="cpu")
    restored = saved[1]
    assert int(restored.folds) == 2
    resumed, state = selectors.select_streaming(
        name, 9, batches[int(restored.folds):], 18, spec, state=restored,
        device="cpu")
    assert torch.equal(resumed, straight) and int(state.folds) == 5
    like = selectors.state_like(5, device="cpu")
    assert like.rows.shape == (0, 5) and like.key.dtype == torch.int64


def test_streaming_rejects_sparse_and_empty():
    sel = selectors.resolve("rls")
    with pytest.raises(ValueError, match="dense"):
        sel.fold(sel.init(0, 4, device="cpu"),
                 torch.from_numpy(_data(8, 4)).to_sparse_csr())
    with pytest.raises(ValueError, match="empty"):
        selectors.select_streaming("uniform", 0, [], 4, KernelSpec(**SPEC),
                                   device="cpu")
    with pytest.raises(ValueError, match="unknown landmark selector"):
        selectors.resolve("bogus")


def test_rls_covers_starved_clusters_better_than_uniform():
    """One dominant cluster (97%) and three tiny ones: RLS puts landmarks
    in the tiny ones where uniform sampling leaves them out."""
    rng = np.random.default_rng(2)
    centers = np.array([[0, 0], [8, 8], [-8, 8], [8, -8]], np.float32)
    sizes = [970, 10, 10, 10]
    x = np.concatenate([rng.normal(c, 0.3, size=(s, 2))
                        for c, s in zip(centers, sizes)]).astype(np.float32)
    y = np.repeat(np.arange(4), sizes)
    perm = rng.permutation(len(x))
    x, y = torch.from_numpy(x[perm]), y[perm]
    spec = KernelSpec("rbf", gamma=0.5)

    def covered(name, key):
        idx = selectors.resolve(name).select_indices(key, x, 8, spec).numpy()
        return len(set(y[idx]) - {0})

    unif = sum(covered("uniform", k) for k in range(8))
    rls = sum(covered("rls", k) for k in range(8))
    assert rls > unif and rls >= 8 * 3 - 4, (rls, unif)


# ---------------------------------------------------------------------------
# fits and dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["exact", "nystrom"])
@pytest.mark.parametrize("name", ["rls", "kpp"])
def test_selector_fit_matches_jax(name, method):
    """tests/test_selectors.py's blobs case (C = 4, B = 4, s = 0.4, rbf
    gamma 8; Nystrom at m = 24): NMI >= 0.9 and within 0.02 of the
    reference's; a fit resumed after two batches equals the uninterrupted
    one."""
    x, y = four_blobs()
    kw = dict(n_clusters=4, n_batches=4, s=0.4, seed=0, selector=name,
              method=method, embed_dim=24 if method == "nystrom" else 0)
    res_j = j_fit_dataset(x, JConfig(kernel=JSpec("rbf", gamma=8.0), **kw))
    nmi_j = j_nmi(y, np.asarray(res_j.predict(x)))
    cfg = MiniBatchConfig(kernel=KernelSpec("rbf", gamma=8.0), **kw)
    res = fit_dataset(x, cfg, device="cpu")
    nmi_t = nmi(y, res.predict(x).numpy())
    assert nmi_t >= 0.9 and abs(nmi_t - nmi_j) <= 0.02, (nmi_t, nmi_j)
    if method == "exact":
        batches = split_batches(x, 4, strategy="stride")
        half = fit(batches[:2], cfg, device="cpu")
        resumed = fit(batches[2:], cfg, state=half.state, device="cpu")
        assert torch.equal(resumed.state.medoids, res.state.medoids)


def test_config_and_feature_map_gate_selectors():
    with pytest.raises(ValueError, match="selector"):
        MiniBatchConfig(n_clusters=4, method="rff", selector="rls")
    with pytest.raises(ValueError, match="selector"):
        MiniBatchConfig(n_clusters=4, method="sketch", selector="kpp")
    with pytest.raises(ValueError, match="unknown landmark selector"):
        MiniBatchConfig(n_clusters=4, selector="bogus")
    MiniBatchConfig(n_clusters=4, method="nystrom",
                    selector=selectors.RLSSelector(delta=1e-3))
    x = torch.from_numpy(_data(16, 4))
    with pytest.raises(ValueError, match="selector"):
        make_feature_map("rff", torch.Generator(), x, 8, KernelSpec("rbf"),
                         selector="rls")
    fmap = make_nystrom(torch.Generator().manual_seed(0), x, 8,
                        KernelSpec("rbf"), selector="kpp")
    assert fmap.landmarks.shape == (8, 4)
    assert math.isfinite(float(fmap.proj.sum()))
