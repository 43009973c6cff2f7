"""The plain reference against the program on tiny CPU fits: the same
draws from the same seeds, the same k-means++ seeds, the same batch steps
and the same RFF map. (The tests may import the program; the reference
never does.)"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.approx.rff import make_rff
from repro_torch.core.init import kmeans_pp_indices
from repro_torch.core.kernels import KernelSpec
from repro_torch.core.minibatch import (MiniBatchConfig, batch_generator,
                                        fit_dataset, map_generator)
from kkbench import cell as C
from kkbench import gen
from kkbench.reference import draws, kkmeans, rff

from .tiny import tiny

SEED = 2**31 + 7


def _data(name):
    cell = tiny(name)
    data = gen.make(cell["data"], SEED, "cpu", SEED)
    return cell, data, C.gamma(cell, data.x)


def test_draws_are_the_programs():
    for seed, i in ((0, 0), (SEED, 3), (12345, 11)):
        a, b = draws.batch_generator(seed, i), batch_generator(seed, i)
        assert torch.equal(torch.rand(5, generator=a),
                           torch.rand(5, generator=b))
    a, b = draws.map_generator(SEED), map_generator(SEED)
    assert torch.equal(torch.randn(4, generator=a), torch.randn(4, generator=b))


def test_generators_repeat_from_the_seed():
    for name in ("noisy-mnist.exact", "md-traj.exact"):
        cell = tiny(name)
        a = gen.make(cell["data"], SEED, "cpu", SEED)
        b = gen.make(cell["data"], SEED, "cpu", SEED)
        c = gen.make(cell["data"], SEED + 1, "cpu", SEED)
        assert torch.equal(a.x, b.x) and torch.equal(a.y_test, b.y_test)
        assert not torch.equal(a.x, c.x)


def test_kpp_seeds_are_the_programs():
    cell, data, g = _data("noisy-mnist.exact")
    x = data.x[:3000]
    spec = KernelSpec("rbf", gamma=g)
    prog = kmeans_pp_indices(x, spec.diag(x), batch_generator(SEED, 0),
                             n_clusters=10, spec=spec)
    ref = kkmeans.kpp_seeds(x, g, 10, draws.batch_generator(SEED, 0))
    assert torch.equal(prog.cpu(), ref.cpu())


def test_batch_steps_match_the_program():
    cell, data, g = _data("noisy-mnist.exact")
    cfg = MiniBatchConfig(n_clusters=10, n_batches=3, kernel=KernelSpec(
        "rbf", gamma=g), seed=SEED)
    states = []
    res = fit_dataset(data.x, cfg, device="cpu",
                      checkpoint_cb=lambda st, i: states.append(st))
    _, _, hist, ref_states = kkmeans.fit(data.x, g, 10, 3, 100,
                                              seed=SEED)
    # batch 0 from the same seeds: the same partition; later batches may
    # part where rows tie to float32 rounding, so they are compared loosely
    assert np.array_equal(ref_states[0][1].numpy(),
                          states[0].cardinalities.numpy())
    assert res.history[0].inner_iters == hist[0][2]
    for h, rh in zip(res.history, hist):
        assert abs(h.cost - rh[0]) / rh[0] < 1e-3
    labels = res.predict(data.x_test).long()
    agree = (labels == kkmeans.predict(data.x_test, res.state.medoids, g))
    assert bool(agree.all())


def test_judge_reads_rounding_on_the_program():
    cell, data, g = _data("noisy-mnist.exact")
    cfg = MiniBatchConfig(n_clusters=10, n_batches=3, kernel=KernelSpec(
        "rbf", gamma=g), seed=5)
    states = []
    res = fit_dataset(data.x, cfg, device="cpu",
                      checkpoint_cb=lambda st, i: states.append(st))
    for i in range(3):
        got = kkmeans.judge_batch(
            data.x[i::3].contiguous(), g, 10, 100, seed=5, i=i,
            cost=res.history[i].cost, counts=res.history[i].counts,
            state_out=states[i], state_in=states[i - 1] if i else None)
        assert got["cost"] < 2e-3 and got["count"] == 0.0
        assert got["medoid"] == 0.0


def test_rff_map_and_fixpoint_match_the_program():
    cell, data, g = _data("noisy-mnist.rff")
    spec = KernelSpec("rbf", gamma=g)
    fm = make_rff(map_generator(SEED), 784, 320, spec, device="cpu")
    w, b = rff.draw_map(SEED, 784, 320, g)
    assert torch.equal(fm.w, w) and torch.equal(fm.b, b)
    cfg = MiniBatchConfig(n_clusters=10, n_batches=1, kernel=spec,
                          method="rff", embed_dim=320, seed=SEED)
    res = fit_dataset(data.x, cfg, device="cpu")
    got = rff.judge_final(rff.embed(data.x, w, b), res.state.centroids,
                          res.state.cardinalities, res.history[0].cost)
    assert got["centroid"] < 1e-6 and got["moved"] < 1e-3
    assert got["cost"] < 1e-4
    ref = rff.fit(data.x, g, 10, 320, 100, seed=SEED)
    assert abs(ref[4] - res.history[0].cost) / ref[4] < 1e-3


@pytest.mark.parametrize("cols,tf32", [(False, False), (True, False),
                                       (False, True)])
def test_blocked_gram_is_the_whole_one(monkeypatch, cols, tf32):
    """E kept in part and built again by every contraction gives the whole
    one's numbers: its products, Eq.5-6 stats and the inner fixpoint."""
    cell, data, g = _data("md-traj.exact")
    x = data.x[:300]
    idx = torch.arange(1, 300, 2) if cols else None
    m = 150 if cols else 300
    whole = kkmeans.Gram(x, g, tf32=tf32, block=64, cols=idx)
    # room for two and a half row blocks of float32
    monkeypatch.setattr(kkmeans, "room", lambda *a: 4.0 * 64 * m * 2.5)
    part = kkmeans.Gram(x, g, tf32=tf32, block=64, cols=idx)
    assert len(whole.kept) == 5 and len(part.kept) == 2
    labels0 = torch.arange(300) % 20
    h = torch.nn.functional.one_hot(labels0 if idx is None else labels0[idx],
                                    20)
    assert torch.equal(whole.apply(h), part.apply(h))
    a, b = kkmeans.stats(whole, labels0, 20), kkmeans.stats(part, labels0, 20)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    a, b = kkmeans.inner(whole, labels0, 20, 100), \
        kkmeans.inner(part, labels0, 20, 100)
    assert torch.equal(a.labels, b.labels) and a.n_iter == b.n_iter
    assert a.cost == b.cost


def test_judge_batch_reads_the_same_on_a_blocked_gram(monkeypatch):
    cell, data, g = _data("md-traj.exact")
    cfg = MiniBatchConfig(n_clusters=20, n_batches=3, kernel=KernelSpec(
        "rbf", gamma=g), seed=5)
    states = []
    res = fit_dataset(data.x, cfg, device="cpu",
                      checkpoint_cb=lambda st, i: states.append(st))
    for i in range(2):
        kw = dict(seed=5, i=i, cost=res.history[i].cost,
                  counts=res.history[i].counts, state_out=states[i],
                  state_in=states[i - 1] if i else None)
        xb = data.x[i::3].contiguous()
        whole = kkmeans.judge_batch(xb, g, 20, 100, **kw)
        with monkeypatch.context() as mp:     # no row block kept
            mp.setattr(kkmeans, "room", lambda *a: 0.0)
            assert kkmeans.judge_batch(xb, g, 20, 100, **kw) == whole


def test_a_meshs_draws_are_the_references():
    """On a mesh of 4 a batch of 1,001 rows has 1,000 landmarks (a
    multiple of 4) drawn from the batch generator, and k-means++ draws
    its seeds among them next: the program's own calls, in its order,
    give the reference's draws."""
    from repro_torch.distributed.outer import DistributedMiniBatchKMeans
    cell, data, g = _data("md-traj.exact")
    spec = KernelSpec("rbf", gamma=g)
    km = object.__new__(DistributedMiniBatchKMeans)
    km.cfg = MiniBatchConfig(n_clusters=20, kernel=spec, seed=SEED)
    km.d_size, km.m_size, km.device = 4, 1, torch.device("cpu")
    xb = data.x[:1001]
    gen, ref_gen = batch_generator(SEED, 0), draws.batch_generator(SEED, 0)
    l_idx, n_l = km._choose_landmarks(gen, xb, 3)
    assert n_l == draws.n_landmarks(1001, 1.0, 20, 4) == 1000
    ref_idx = draws.landmarks(ref_gen, 1001, n_l)
    assert torch.equal(l_idx, ref_idx)
    xl = xb[l_idx]
    prog = kmeans_pp_indices(xl, spec.diag(xl), gen, n_clusters=20,
                             spec=spec)
    assert torch.equal(prog, kkmeans.kpp_seeds(xl, g, 20, ref_gen))
    # a batch the mesh divides: every row a landmark, nothing drawn
    assert draws.n_landmarks(1000, 1.0, 20, 4) == 1000
    assert draws.landmarks(ref_gen, 1000, 1000) is None
