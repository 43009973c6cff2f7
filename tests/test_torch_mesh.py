"""The port's mesh (``repro_torch.distributed``) on the CPU over gloo,
against the reference's own mesh classes and the port's single-host loops.

The oracle: the reference's ``distributed_kkmeans_fit``,
``DistributedMiniBatchKMeans`` and ``DistributedEmbedKMeans`` run in this
process on the reference's one-device mesh (``repro.distributed.
make_test_mesh()``), once per module. Their draws (k-means++ seeds, the
count sketch's tables) are recorded and injected into the port, whose
draws come from torch generators.

The port runs every case at world 1 in this process, at world 2 on a
(2, 1) mesh and at world 4 on (2, 2) and (4, 1) meshes, and the s-step
cases at world 8 on the reference's own (4, 2) s-step mesh, in spawned
gloo worlds: one spawn per world size, which returns every case's result,
each case then its own parametrised test. The worlds rendezvous through a
FileStore under the test's temporary directory (no TCP port), the children
run one torch thread each, and a spawned world has 120 s to finish, after
which its children are killed and the test fails.

The contracts are the reference's own mesh tests' (tests/
test_distributed.py): the inner labels equal the single-host inner loop's
(g within 1e-4, cost within 1e-2) in every engine mode on the 1-D and 2-D
layouts, with exactly one all_gather and one all_reduce a sync (counted by
a wrapper around ``torch.distributed``); s_step = 2 lands on the
synchronous partition on both layouts (the 2-D one on the (4, 2) mesh; on
(2, 2) the 2-D loop equals the reference's run on its own (2, 2) mesh of
four host devices, made in a subprocess), and on 2-D the replicas leave
every sync with the same labels, whose stats the result holds; the exact outer
loop matches the reference's mesh fit and the single-host fit; ghost rows
leave the cardinalities and the Eq.12 medoids exactly those of the single
host; an exact resume is bitwise the straight fit; the CSR sketch fit
labels as the dense single-host fit and the reference's mesh fit
(centroids within 1e-5), one all_reduce a Lloyd sweep; a tail batch
smaller than the mesh is staged, not crashed; the streaming sharded CSR fit
(densification booby-trapped) equals the single-host dense oracle, and so
does its mid-stream resume on a mesh of fewer row shards.
"""
import contextlib
import datetime
import math
import os
import pickle
import subprocess
import sys
import textwrap
import time
import traceback

import numpy as np
import pytest
import torch

DEADLINE = 120.0
MODES = ("materialize", "fused", "tiled")
#: name -> (world size, mesh axes, the inner loop's layout)
CONFIGS = {"w1": (1, {"data": 1, "model": 1}, "2d"),
           "w2": (2, {"data": 2, "model": 1}, "1d"),
           "w4-2x2": (4, {"data": 2, "model": 2}, "2d"),
           "w4-4x1": (4, {"data": 4, "model": 1}, "1d")}
#: the reference's own s-step mesh (tests/test_distributed.py:490), a world
#: of 8 that runs the s-step cases only (SSTEP_CASES)
SSTEP_CONFIGS = {"w8-4x2": (8, {"data": 4, "model": 2}, "2d")}
SSTEP_CASES = ("sstep", "replicas")
ALL_CONFIGS = {**CONFIGS, **SSTEP_CONFIGS}
#: a mesh of the same world with fewer row shards (a resume's)
SMALLER = {"w1": {"data": 1, "model": 1}, "w2": {"data": 1, "model": 2},
           "w4-2x2": {"data": 1, "model": 4},
           "w4-4x1": {"data": 2, "model": 2},
           "w8-4x2": {"data": 2, "model": 4}}


# ---------------------------------------------------------------------------
# data (the reference tests' fixtures; numpy, so both packages take them)
# ---------------------------------------------------------------------------


def _blobs(n_per, seed, sigma=0.05):
    """Four well-separated 2-d blobs, shuffled, and their labels."""
    rng = np.random.default_rng(seed)
    centers = np.array([[0.25, 0.25], [0.75, 0.75], [0.25, 0.75],
                        [0.75, 0.25]])
    x = np.concatenate([rng.normal(c, sigma, size=(n_per, 2))
                        for c in centers]).astype(np.float32)
    y = np.repeat(np.arange(4), n_per)
    perm = rng.permutation(len(x))
    return x[perm], y[perm]


def _inner_data():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(256, 8)).astype(np.float32)
    u0 = rng.integers(0, 5, 256).astype(np.int32)
    return x, u0, 0.2


def _sstep_data():
    rng = np.random.default_rng(7)
    centers = np.array([[0.2, 0.2], [0.8, 0.8], [0.2, 0.8], [0.8, 0.2]])
    x = np.concatenate([rng.normal(c, 0.05, size=(128, 2))
                        for c in centers]).astype(np.float32)
    x = x[rng.permutation(len(x))]
    u0 = rng.integers(0, 4, 512).astype(np.int32)
    return x, u0


def _outer_data():
    return _blobs(512, 0)


def _csr_sizes():
    return dict(n=2048, vocab=4096, c=8, b=4, m=128)


# ---------------------------------------------------------------------------
# the oracle: the reference's mesh classes on its one-device mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def oracle():
    import jax.numpy as jnp
    import repro.distributed.embed as j_embed
    import repro.distributed.outer as j_outer
    from repro.core import KernelSpec as JSpec
    from repro.core import MiniBatchConfig as JConfig
    from repro.data import sparse as jsp
    from repro.data import synthetic as j_synthetic
    from repro.data.sampling import split_batches
    from repro.distributed import make_test_mesh as j_mesh
    from repro.distributed.inner import (DistributedInnerConfig,
                                         distributed_kkmeans_fit)

    mesh = j_mesh()
    out = {}
    x, u0, gamma = _inner_data()
    spec = JSpec("rbf", gamma=gamma)
    xj = jnp.asarray(x)
    for mode in MODES:
        res = distributed_kkmeans_fit(
            mesh, xj, xj, jnp.arange(256, dtype=jnp.int32), spec.diag(xj),
            jnp.asarray(u0), cfg=DistributedInnerConfig(
                n_clusters=5, kernel=spec, engine=mode))
        out["inner", mode] = (np.asarray(res.labels), np.asarray(res.g),
                              float(res.cost))

    def spy(module, name, key):
        real = getattr(module, name)

        def wrapped(*a, **k):
            got = real(*a, **k)
            out[key] = np.asarray(got)
            return got
        return real, wrapped

    x, _ = _outer_data()
    cfg = JConfig(n_clusters=4, n_batches=4, s=1.0,
                  kernel=JSpec("rbf", gamma=8.0), seed=0)
    real, wrapped = spy(j_outer, "kmeans_pp_indices", "outer_seeds")
    j_outer.kmeans_pp_indices = wrapped
    try:
        res = j_outer.DistributedMiniBatchKMeans(mesh, cfg,
                                                 mode="fused").fit(
            split_batches(x, 4, strategy="stride"))
    finally:
        j_outer.kmeans_pp_indices = real
    out["outer"] = (np.asarray(res.state.medoids),
                    np.asarray(res.state.cardinalities))

    sz = _csr_sizes()
    xs, _ = j_synthetic.make_rcv1_sparse(sz["n"], vocab=sz["vocab"],
                                         n_classes=sz["c"], seed=0)
    cfg = JConfig(n_clusters=sz["c"], n_batches=sz["b"],
                  kernel=JSpec("linear"), seed=0, method="sketch",
                  embed_dim=sz["m"])
    real, wrapped = spy(j_embed, "kmeans_pp_indices", "csr_seeds")
    j_embed.kmeans_pp_indices = wrapped
    try:
        res = j_embed.DistributedEmbedKMeans(mesh, cfg).fit(
            jsp.split_csr(xs, sz["b"], strategy="stride"))
    finally:
        j_embed.kmeans_pp_indices = real
    out["csr"] = (np.asarray(res.state.centroids),
                  np.asarray(res.predict(xs)), np.asarray(res.fmap.h),
                  np.asarray(res.fmap.sign))
    return out


# ---------------------------------------------------------------------------
# the cases, run on every rank of a world
# ---------------------------------------------------------------------------


class _Count:
    """Counts the collectives the runtime makes: a wrapper around
    ``torch.distributed.all_gather_into_tensor`` and ``all_reduce``."""

    def __enter__(self):
        import torch.distributed as dist
        self.n = {"all_gather": 0, "all_reduce": 0}
        self._real = (dist.all_gather_into_tensor, dist.all_reduce)

        def ag(*a, **k):
            self.n["all_gather"] += 1
            return self._real[0](*a, **k)

        def ar(*a, **k):
            self.n["all_reduce"] += 1
            return self._real[1](*a, **k)
        dist.all_gather_into_tensor, dist.all_reduce = ag, ar
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.all_gather_into_tensor, dist.all_reduce = self._real
        return False


@contextlib.contextmanager
def _patched(obj, name, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


def _inner_cfg(layout, **kw):
    from repro_torch.distributed import DistributedInnerConfig
    return DistributedInnerConfig(
        row_axes=("data",), col_axis="model" if layout == "2d" else None,
        **kw)


def case_inner(mesh, small, layout, oracle, mode):
    from repro_torch.core import KernelSpec
    from repro_torch.core.kkmeans import kkmeans_fit
    from repro_torch.distributed import distributed_kkmeans_fit
    x, u0, gamma = _inner_data()
    spec = KernelSpec("rbf", gamma=gamma)
    x, u0 = torch.from_numpy(x), torch.from_numpy(u0)
    diag, l_idx = spec.diag(x), torch.arange(256)
    host = kkmeans_fit(x, l_idx, diag, u0, spec=spec, n_clusters=5,
                       engine=mode)
    with _Count() as count:
        res = distributed_kkmeans_fit(
            mesh, x, x, l_idx, diag, u0,
            cfg=_inner_cfg(layout, n_clusters=5, kernel=spec, engine=mode))
    lab_o, g_o, cost_o = oracle["inner", mode]
    return {"same_host": bool(torch.equal(res.labels, host.labels)),
            "g_err": float((res.g - host.g).abs().max()),
            "cost_err": abs(float(res.cost) - float(host.cost)),
            "same_oracle": bool(np.array_equal(res.labels.numpy(), lab_o)),
            "g_oracle_err": float(np.abs(res.g.numpy() - g_o).max()),
            "cost_oracle_err": abs(float(res.cost) - cost_o),
            "calls": count.n, "n_iter": res.n_iter}


#: the s-step partition contract's layout: the config's, but 1-D on the
#: (2, 2) mesh (see test_sstep_matches_synchronous_partition)
SSTEP_LAYOUT = {"w1": "2d", "w2": "1d", "w4-2x2": "1d", "w4-4x1": "1d",
                "w8-4x2": "2d"}


def case_sstep(mesh, small, layout, oracle, config):
    """s_step = 1 and 2 on SSTEP_LAYOUT's layout (the partition contract);
    where the config's own layout differs, its s_step = 1 and 2 runs too
    (labels, cost and syncs, held to the reference's on the same mesh)."""
    from repro_torch.core import KernelSpec
    from repro_torch.distributed import distributed_kkmeans_fit
    x, u0 = (torch.from_numpy(a) for a in _sstep_data())
    spec = KernelSpec("rbf", gamma=8.0)

    def run(lay, s):
        with _Count() as count:
            res = distributed_kkmeans_fit(
                mesh, x, x, torch.arange(512), spec.diag(x), u0,
                cfg=_inner_cfg(lay, n_clusters=4, kernel=spec, s_step=s))
        return res, count.n
    runs, calls = {}, {}
    for s in (1, 2):
        runs[s], n = run(SSTEP_LAYOUT[config], s)
        calls[s] = (n, runs[s].n_iter)
    l1, l2 = runs[1].labels.tolist(), runs[2].labels.tolist()
    pairs = set(zip(l1, l2))
    out = {"same": len(pairs) == len(set(l1)) == len(set(l2)),
           "cost_err": abs(float(runs[1].cost) - float(runs[2].cost)),
           "syncs_1": runs[1].n_iter, "syncs_2": runs[2].n_iter,
           "calls": calls}
    if layout != SSTEP_LAYOUT[config]:
        out["own"] = {}
        for s in (1, 2):
            res, _ = run(layout, s)
            out["own"][s] = (res.labels.numpy(), float(res.cost),
                             res.n_iter)
    return out


def case_replicas(mesh, small, layout, oracle):
    """2-D s-step: the replicas leave each sync with one label vector, and
    the result's f / g / counts are that vector's stats."""
    from repro_torch.core import KernelSpec
    from repro_torch.core.engine import (GramEngine, engine_stats_raw,
                                         finalize_stats)
    from repro_torch.distributed import distributed_kkmeans_fit
    from repro_torch.distributed.inner import split_rows
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(size=(512, 6)).astype(np.float32))
    u0 = torch.from_numpy(rng.integers(0, 5, 512).astype(np.int32))
    spec = KernelSpec("rbf", gamma=2.0)
    out = {}
    for s in (2, 4):
        res = distributed_kkmeans_fit(
            mesh, x, x, torch.arange(512), spec.diag(x), u0,
            cfg=_inner_cfg("2d", n_clusters=5, kernel=spec, max_iters=8,
                           s_step=s))
        eng = GramEngine(mode="materialize")
        op = eng.prepare(spec, x, x)
        f, g, counts = finalize_stats(*engine_stats_raw(
            eng, spec, op, op, res.labels, res.labels, 5))
        blk = split_rows(mesh, ("data",), 512)
        out[s] = {"labels": res.labels.numpy(),
                  "counts_ok": bool(torch.equal(counts, res.counts)),
                  "f_err": float((f[blk] - res.f).abs().max()),
                  "g_err": float((g - res.g).abs().max())}
    return out


def _outer_cfg(**kw):
    from repro_torch.core import KernelSpec, MiniBatchConfig
    return MiniBatchConfig(**{**dict(n_clusters=4, n_batches=4, s=1.0,
                                     kernel=KernelSpec("rbf", gamma=8.0),
                                     seed=0, engine="fused"), **kw})


def case_outer(mesh, small, layout, oracle):
    import repro_torch.distributed.outer as outer
    from repro_torch.core import clustering_accuracy, fit, predict
    from repro_torch.data.sampling import split_batches
    x, y = _outer_data()
    cfg = _outer_cfg()
    batches = split_batches(x, 4, strategy="stride")
    seeds = torch.from_numpy(oracle["outer_seeds"].astype(np.int64))
    with _patched(outer, "kmeans_pp_indices", lambda *a, **k: seeds):
        injected = outer.DistributedMiniBatchKMeans(mesh, cfg).fit(batches)
    with _Count() as count:
        own = outer.DistributedMiniBatchKMeans(mesh, cfg).fit(batches)
    host = fit(batches, cfg, device="cpu")
    med_o, cards_o = oracle["outer"]
    st = injected.state
    xt = torch.from_numpy(x)
    lab = predict(xt, st.medoids, st.medoid_diag, spec=cfg.kernel,
                  device="cpu").numpy()
    lab_o = predict(xt, torch.from_numpy(med_o), cfg.kernel.diag(
        torch.from_numpy(med_o)), spec=cfg.kernel, device="cpu").numpy()
    iters = [h.inner_iters for h in own.history]
    return {"acc": clustering_accuracy(y, lab),
            "total": float(st.cardinalities.sum()), "n": len(x),
            "cards_oracle": bool(np.array_equal(st.cardinalities.numpy(),
                                                cards_o)),
            "labels_oracle": bool(np.array_equal(lab, lab_o)),
            "host_medoids": bool(torch.equal(own.state.medoids,
                                             host.state.medoids)),
            "host_cards": bool(torch.equal(own.state.cardinalities,
                                           host.state.cardinalities)),
            "calls": count.n,
            # a sync a loop body plus the prologue, and the argmins'
            # gathers: batch 0's Eq.7, then Eq.7 and Eq.12 a batch
            "want_calls": {"all_gather": sum(iters) + len(iters)
                           + 1 + 2 * (len(iters) - 1),
                           "all_reduce": sum(iters) + len(iters)}}


def _lcm_of(mesh):
    from repro_torch.distributed.mesh import mesh_shape
    shape = mesh_shape(mesh)
    return math.lcm(shape["data"], shape["model"])


def case_ghost(mesh, small, layout, oracle):
    """P does not divide the batch: from one shared state, the mesh fit's
    cardinalities and medoids are the single host's exactly."""
    from repro_torch.core import KernelSpec, MiniBatchConfig, fit
    from repro_torch.distributed import DistributedMiniBatchKMeans
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2048 + 1027, 8)).astype(np.float32)
    cfg = MiniBatchConfig(n_clusters=5, n_batches=2, s=0.5,
                          kernel=KernelSpec("rbf", gamma=0.5),
                          max_inner_iters=4, seed=3,
                          landmark_multiple_of=_lcm_of(mesh))
    st0 = fit([x[:2048]], cfg, device="cpu").state
    dist = DistributedMiniBatchKMeans(mesh, cfg).fit([x[2048:]], state=st0)
    host = fit([x[2048:]], cfg, state=st0, device="cpu")
    n_l = -(-math.ceil(0.5 * 1027) // _lcm_of(mesh)) * _lcm_of(mesh)
    return {"cards_equal": bool(torch.equal(dist.state.cardinalities,
                                            host.state.cardinalities)),
            "medoid_diff": float((dist.state.medoids
                                  - host.state.medoids).abs().max()),
            "total": float(dist.state.cardinalities.sum()),
            "want_total": float(st0.cardinalities.sum()) + n_l}


def case_resume(mesh, small, layout, oracle):
    """Per-batch draws from (seed, i): a resumed mesh fit is bitwise the
    straight one, on the smaller mesh too."""
    from repro_torch.core import KernelSpec, MiniBatchConfig
    from repro_torch.data.sampling import split_batches
    from repro_torch.distributed import DistributedMiniBatchKMeans
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1024, 8)).astype(np.float32)
    lcm = math.lcm(_lcm_of(mesh), _lcm_of(small))
    cfg = MiniBatchConfig(n_clusters=6, n_batches=4, s=0.4,
                          kernel=KernelSpec("rbf", gamma=0.5),
                          max_inner_iters=3, seed=5, landmark_multiple_of=lcm)
    batches = split_batches(x, 4, strategy="stride")
    straight = DistributedMiniBatchKMeans(mesh, cfg).fit(batches)
    half = DistributedMiniBatchKMeans(mesh, cfg).fit(batches[:2])
    resumed = DistributedMiniBatchKMeans(mesh, cfg).fit(batches[2:],
                                                        state=half.state)
    on_small = DistributedMiniBatchKMeans(small, cfg).fit(batches[2:],
                                                          state=half.state)
    return {"same": all(torch.equal(a, b) for a, b in
                        zip(straight.state[:3], resumed.state[:3])),
            "same_small": all(torch.equal(a, b) for a, b in
                              zip(straight.state[:3], on_small.state[:3]))}


def _csr_cfg():
    from repro_torch.core import KernelSpec, MiniBatchConfig
    sz = _csr_sizes()
    return MiniBatchConfig(n_clusters=sz["c"], n_batches=sz["b"],
                           kernel=KernelSpec("linear"), seed=0,
                           method="sketch", embed_dim=sz["m"])


def case_csr(mesh, small, layout, oracle):
    import repro_torch.distributed.embed as embed
    from repro_torch import convert
    from repro_torch.core import fit
    from repro_torch.data import sparse as tsp
    from repro_torch.data.sampling import split_batches
    from repro_torch.data.synthetic import make_rcv1_sparse
    sz = _csr_sizes()
    xs, _ = make_rcv1_sparse(sz["n"], vocab=sz["vocab"], n_classes=sz["c"],
                             seed=0)
    cfg = _csr_cfg()
    dense = tsp.to_dense(xs)
    # the port's own draws: the mesh CSR fit against the host dense fit
    km = embed.DistributedEmbedKMeans(mesh, cfg)
    with km.source(tsp.split_csr(xs, sz["b"], strategy="stride"),
                   depth=2) as src, _Count() as count:
        res = km.fit(src)
    host = fit(split_batches(dense, sz["b"], strategy="stride"), cfg,
               device="cpu")
    # the reference's draws injected: against its mesh fit
    cents_o, lab_o, h_o, sign_o = oracle["csr"]
    fmap = convert.feature_map_from_numpy(
        "sketch", {"h": h_o, "sign": sign_o}, {"m": sz["m"]}, "cpu")
    seeds = torch.from_numpy(oracle["csr_seeds"].astype(np.int64))
    with _patched(embed, "draw_first", lambda *a, **k: seeds):
        inj = embed.DistributedEmbedKMeans(mesh, cfg, fmap=fmap).fit(
            tsp.split_csr(xs, sz["b"], strategy="stride"))
    iters = [h.inner_iters for h in res.history]
    return {"same_host": bool(torch.equal(res.predict(xs),
                                          host.predict(dense))),
            "cerr_host": float((res.state.centroids
                                - host.state.centroids).abs().max()),
            "total": float(res.state.cardinalities.sum()), "n": sz["n"],
            "same_oracle": bool(np.array_equal(inj.predict(xs).numpy(),
                                               lab_o)),
            "cerr_oracle": float(np.abs(inj.state.centroids.numpy()
                                        - cents_o).max()),
            # one all_reduce a Lloyd sweep and the prologue's; batch 0's
            # seeding gathers the embedded rows once
            "calls": count.n,
            "want_calls": {"all_gather": 1,
                           "all_reduce": sum(iters) + len(iters)}}


def case_tail(mesh, small, layout, oracle):
    """A stream's last batch smaller than the mesh rows is staged with
    ghost rows: exact masked cardinalities; a staged first batch gives a
    data-dependent map the inline path's sample; a first batch that does
    not divide the mesh seeds as the single host."""
    from repro_torch.core import KernelSpec, MiniBatchConfig, fit
    from repro_torch.data.sparse import csr_from_dense
    from repro_torch.distributed import (DistributedEmbedKMeans,
                                         DistributedMiniBatchKMeans)
    rng = np.random.default_rng(0)
    n = 2048 + 3
    x = rng.normal(size=(n, 64)).astype(np.float32)
    x *= rng.random((n, 64)) < 0.2
    cfg = MiniBatchConfig(n_clusters=4, n_batches=2,
                          kernel=KernelSpec("linear"), seed=0,
                          method="sketch", embed_dim=64)
    km = DistributedEmbedKMeans(mesh, cfg)
    with km.source([csr_from_dense(x[:2048]), csr_from_dense(x[2048:])],
                   depth=2) as src:
        res_csr = km.fit(src)
    dense_total = float(DistributedEmbedKMeans(mesh, cfg).fit(
        [x[:2048], x[2048:]]).state.cardinalities.sum())
    cfg_ny = MiniBatchConfig(n_clusters=3, n_batches=1,
                             kernel=KernelSpec("rbf", gamma=0.5), seed=1,
                             method="nystrom", embed_dim=12)
    xb = rng.normal(size=(1021, 16)).astype(np.float32)
    inline = DistributedEmbedKMeans(mesh, cfg_ny).fit([xb])
    km2 = DistributedEmbedKMeans(mesh, cfg_ny)
    with km2.source([xb], depth=1) as src:
        staged = km2.fit(src)
    first_nd = [csr_from_dense(x[:1027]), csr_from_dense(x[1027:2048])]
    res_nd = DistributedEmbedKMeans(mesh, cfg).fit(first_nd)
    host_nd = fit([x[:1027], x[1027:2048]], cfg, device="cpu")
    # the exact path over the same 3-row tail (two clusters, so that a
    # 3-row batch holds its landmarks on every mesh)
    cfg_ex = MiniBatchConfig(n_clusters=2, n_batches=2, s=1.0,
                             kernel=KernelSpec("rbf", gamma=0.5), seed=0)
    res_ex = DistributedMiniBatchKMeans(mesh, cfg_ex).fit(
        [x[:2048], x[2048:]])
    return {"csr_total": float(res_csr.state.cardinalities.sum()),
            "dense_total": dense_total, "n": n,
            "ny_same": bool(torch.equal(inline.state.centroids,
                                        staged.state.centroids)),
            "seed_same": bool(torch.equal(
                res_nd.predict(csr_from_dense(x[:2048])),
                host_nd.predict(x[:2048]))),
            "exact_batches": res_ex.state.batches_done}


def case_stream(mesh, small, layout, oracle, workdir):
    """Ragged CSR chunks -> stream_blocks -> staging on a producer thread
    -> the O(nnz) sketch on each rank -> one all_reduce a sweep, with every
    densification route booby-trapped; then a failure after 2 committed
    batches and an elastic resume on the smaller mesh."""
    import repro_torch.approx.sketch as sketch_mod
    import repro_torch.data.sparse as sparse_mod
    from repro_torch.core import KernelSpec, MiniBatchConfig, fit
    from repro_torch.data.loader import BatchSource
    from repro_torch.data.sampling import split_batches
    from repro_torch.data.synthetic import make_rcv1_sparse
    from repro_torch.distributed import DistributedEmbedKMeans
    from repro_torch.ft import (CheckpointManager, ElasticClusteringRunner,
                                SimulatedFailure)
    n, vocab, c, b = 512, 40960, 10, 4
    xs, _ = make_rcv1_sparse(n, vocab=vocab, n_classes=c, seed=0)
    dense = sparse_mod.to_dense(xs)
    cfg = MiniBatchConfig(n_clusters=c, n_batches=b, sampling="block",
                          kernel=KernelSpec("linear"), seed=0,
                          method="sketch", embed_dim=128)

    def stream():
        rng = np.random.default_rng(1)
        bounds = np.unique(np.concatenate(
            [[0], rng.integers(1, n, size=17), [n]]))
        for a, z in zip(bounds[:-1], bounds[1:]):
            yield sparse_mod.slice_rows(xs, int(a), int(z))

    def boom(*a, **k):
        raise AssertionError("dense [n, d] path hit in the CSR pipeline")

    with contextlib.ExitStack() as traps:
        for mod, name in ((sparse_mod, "to_dense"),
                          (sketch_mod, "count_sketch_features"),
                          (sketch_mod, "tensor_sketch_features")):
            traps.enter_context(_patched(mod, name, boom))
        km = DistributedEmbedKMeans(mesh, cfg)
        with BatchSource.from_stream(stream(), n // b, stage=km.stage,
                                     prefetch=2) as src:
            straight = km.fit(src)
        # the checkpoints in a directory every rank sees
        runner = ElasticClusteringRunner(cfg, CheckpointManager(workdir))
        failed = False
        try:
            runner.run(mesh, BatchSource.from_stream(
                stream(), n // b, device="cpu"), fail_after=2)
        except SimulatedFailure:
            failed = True
        resumed = runner.run(small, BatchSource.from_stream(
            stream(), n // b, device="cpu"))
    oracle_fit = fit(split_batches(dense, b, strategy="block"), cfg,
                     device="cpu")
    lab_s = straight.predict(xs)
    return {"failed": failed,
            "oracle_same": bool(torch.equal(lab_s,
                                            oracle_fit.predict(dense))),
            "resume_same": bool(torch.equal(resumed.predict(xs), lab_s)),
            "resume_bitwise": bool(torch.equal(resumed.state.centroids,
                                               straight.state.centroids)),
            "batches": resumed.state.batches_done,
            "cards": float(straight.state.cardinalities.sum())}


CASES = {**{f"inner-{m}": (lambda m: lambda *a: case_inner(*a, mode=m))(m)
            for m in MODES},
         "sstep": case_sstep, "replicas": case_replicas,
         "outer": case_outer, "ghost": case_ghost, "resume": case_resume,
         "csr": case_csr, "tail": case_tail, "stream": case_stream}


def _run_configs(names, oracle, out_dir) -> dict:
    """Every case on every config of this world -> {config: {case:
    result or {"error": traceback}}}; ``out_dir`` is shared by the ranks."""
    from repro_torch.distributed import make_test_mesh
    out = {}
    for name in names:
        _, axes, layout = ALL_CONFIGS[name]
        mesh = make_test_mesh(axes, device="cpu")
        small = make_test_mesh(SMALLER[name], device="cpu")
        out[name] = {}
        for case, fn in CASES.items():
            if name in SSTEP_CONFIGS and case not in SSTEP_CASES:
                continue
            try:
                kw = ({"config": name} if fn is case_sstep else
                      {"workdir": os.path.join(out_dir, f"ck-{name}")}
                      if fn is case_stream else {})
                out[name][case] = fn(mesh, small, layout, oracle, **kw)
            except Exception:
                out[name][case] = {"error": traceback.format_exc()}
    return out


def _init(rank, world, store_path):
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))


def _child(rank, world, store_path, out_dir, names, oracle):
    import warnings
    warnings.simplefilter("ignore")
    torch.set_num_threads(1)
    import torch.distributed as dist
    _init(rank, world, store_path)
    try:
        got = _run_configs(names, oracle, out_dir)
    except Exception:
        got = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(got, f)
    dist.destroy_process_group()


def spawn_world(fn, world, args, out_dir, deadline=DEADLINE) -> list:
    """Run ``fn(rank, world, store, out_dir, *args)`` on ``world`` spawned
    ranks rendezvousing through a FileStore in ``out_dir``; kill them and
    fail after ``deadline`` seconds. -> the ranks' pickled results."""
    import torch.multiprocessing as mp
    store = os.path.join(out_dir, "store")
    ctx = mp.start_processes(fn, args=(world, store, out_dir, *args),
                             nprocs=world, join=False, start_method="spawn")
    t0 = time.monotonic()
    try:
        while not ctx.join(timeout=max(0.1, deadline
                                       - (time.monotonic() - t0))):
            if time.monotonic() - t0 > deadline:
                pytest.fail(f"a world of {world} ranks passed its "
                            f"{deadline} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def run_in_process(fn, out_dir):
    """A world of one in this process: init, ``fn()``, destroy."""
    import torch.distributed as dist
    _init(0, 1, os.path.join(out_dir, "store"))
    try:
        return fn()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_runs(oracle, tmp_path_factory):
    """config -> {case: [result of each rank]}; one run per world size."""
    cache = {}

    def get(config):
        world = ALL_CONFIGS[config][0]
        if world not in cache:
            names = [c for c, v in ALL_CONFIGS.items() if v[0] == world]
            out_dir = str(tmp_path_factory.mktemp(f"world{world}"))
            if world == 1:
                ranks = [run_in_process(
                    lambda: _run_configs(names, oracle, out_dir), out_dir)]
            else:
                ranks = spawn_world(_child, world, (names, oracle), out_dir)
            for r in ranks:
                assert "error" not in r, r.get("error")
            cache[world] = {c: {case: [r[c][case] for r in ranks]
                                for case in ranks[0][c]} for c in names}
        return cache[world][config]
    return get


def _case(runs, case):
    per_rank = runs[case]
    for r in per_rank:
        assert "error" not in r, r["error"]
    return per_rank


# ---------------------------------------------------------------------------
# the tests: one per case and mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("mode", MODES)
def test_inner_matches_host_and_reference(mesh_runs, config, mode):
    for r in _case(mesh_runs(config), f"inner-{mode}"):
        assert r["same_host"], "labels diverged from the host inner loop"
        assert r["g_err"] < 1e-4 and r["g_oracle_err"] < 1e-4
        assert r["cost_err"] < 1e-2 and r["cost_oracle_err"] < 1e-2
        assert r["same_oracle"], "labels diverged from the reference's mesh"
        # exactly one all_gather and one all_reduce a sync, prologue
        # included
        want = r["n_iter"] + 1
        assert r["calls"] == {"all_gather": want, "all_reduce": want}


@pytest.mark.parametrize("config", list(ALL_CONFIGS))
def test_sstep_matches_synchronous_partition(mesh_runs, config):
    """The reference holds this contract on its (4, 2) mesh, and so does
    the port (w8-4x2, a world of 8). On a (2, 2) mesh the reference's 2-D
    s-step loop does not: it stops at cost 208.46 against the synchronous
    loop's 145.69. The port does the same there, run for run
    (test_sstep_2d_on_2x2_equals_the_references), so the (2, 2) mesh is
    held to this contract on the 1-D layout, and on the 2-D layout to the
    reference's own run and to test_sstep_2d_replicas_stay_consistent."""
    for r in _case(mesh_runs(config), "sstep"):
        assert r["same"], "s_step=2 partition != synchronous loop"
        assert r["cost_err"] < 1e-3
        assert 1 <= r["syncs_2"] <= r["syncs_1"] + 2
        for calls, n_iter in r["calls"].values():
            assert calls == {"all_gather": n_iter + 1,
                             "all_reduce": n_iter + 1}


@pytest.mark.parametrize("config", list(ALL_CONFIGS))
def test_sstep_2d_replicas_stay_consistent(mesh_runs, config):
    ranks = _case(mesh_runs(config), "replicas")
    for s in (2, 4):
        for r in ranks:
            assert r[s]["counts_ok"]
            assert r[s]["f_err"] < 1e-4 and r[s]["g_err"] < 1e-4
            assert np.array_equal(r[s]["labels"], ranks[0][s]["labels"])


@pytest.fixture(scope="module")
def reference_sstep_2x2(tmp_path_factory):
    """The reference's 2-D s-step loop on its own (2, 2) mesh of four host
    devices, in a subprocess (the device count is fixed before jax is
    imported): {s: (labels, cost, syncs)} for s_step = 1 and 2."""
    tmp = tmp_path_factory.mktemp("ref2x2")
    x, u0 = _sstep_data()
    np.save(tmp / "x.npy", x)
    np.save(tmp / "u0.npy", u0)
    script = textwrap.dedent(f"""\
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax
        import jax.numpy as jnp
        import numpy as np
        from repro.core import KernelSpec
        from repro.distributed.inner import (DistributedInnerConfig,
                                             distributed_kkmeans_fit)
        x = jnp.asarray(np.load({str(tmp / "x.npy")!r}))
        u0 = jnp.asarray(np.load({str(tmp / "u0.npy")!r}))
        spec = KernelSpec("rbf", gamma=8.0)
        mesh = jax.make_mesh((2, 2), ("data", "model"))
        for s in (1, 2):
            res = distributed_kkmeans_fit(
                mesh, x, x, jnp.arange(512, dtype=jnp.int32), spec.diag(x),
                u0, cfg=DistributedInnerConfig(
                    n_clusters=4, kernel=spec, s_step=s,
                    row_axes=("data",), col_axis="model"))
            np.save({str(tmp)!r} + f"/labels{{s}}.npy", np.asarray(res.labels))
            np.save({str(tmp)!r} + f"/stats{{s}}.npy",
                    np.array([float(res.cost), int(res.n_iter)]))
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=DEADLINE)
    assert out.returncode == 0, out.stderr[-4000:]
    got = {}
    for s in (1, 2):
        cost, syncs = np.load(tmp / f"stats{s}.npy")
        got[s] = (np.load(tmp / f"labels{s}.npy"), float(cost), int(syncs))
    return got


@pytest.mark.parametrize("s", [1, 2])
def test_sstep_2d_on_2x2_equals_the_references(mesh_runs,
                                               reference_sstep_2x2, s):
    """On a (2, 2) mesh the 2-D loop, s-step or not, gives the reference's
    labels, cost and syncs on its own (2, 2) mesh: where the s-step loop
    misses the synchronous partition there (cost 208.46 against 145.69),
    the reference misses it the same way."""
    labels, cost, syncs = reference_sstep_2x2[s]
    for r in _case(mesh_runs("w4-2x2"), "sstep"):
        got_labels, got_cost, got_syncs = r["own"][s]
        np.testing.assert_array_equal(got_labels, labels)
        assert abs(got_cost - cost) < 1e-2
        assert got_syncs == syncs


@pytest.mark.parametrize("config", list(CONFIGS))
def test_exact_outer_matches_reference_and_host(mesh_runs, config):
    for r in _case(mesh_runs(config), "outer"):
        assert r["acc"] > 0.95 and r["total"] == r["n"]
        assert r["cards_oracle"] and r["labels_oracle"]
        assert r["host_medoids"] and r["host_cards"]
        assert r["calls"] == r["want_calls"]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_exact_ghost_rows_unbiased(mesh_runs, config):
    for r in _case(mesh_runs(config), "ghost"):
        assert r["cards_equal"], "ghost rows biased the cardinalities"
        assert r["medoid_diff"] == 0.0
        assert r["total"] == r["want_total"]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_exact_resume_bitwise(mesh_runs, config):
    for r in _case(mesh_runs(config), "resume"):
        assert r["same"] and r["same_small"]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_csr_fit_equals_dense_oracle(mesh_runs, config):
    for r in _case(mesh_runs(config), "csr"):
        assert r["same_host"] and r["cerr_host"] < 1e-5
        assert r["total"] == r["n"]
        assert r["same_oracle"] and r["cerr_oracle"] < 1e-5
        assert r["calls"] == r["want_calls"]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_tail_batch_smaller_than_mesh_is_staged(mesh_runs, config):
    for r in _case(mesh_runs(config), "tail"):
        assert r["csr_total"] == r["n"] and r["dense_total"] == r["n"]
        assert r["ny_same"] and r["seed_same"]
        assert r["exact_batches"] == 2


@pytest.mark.parametrize("config", list(CONFIGS))
def test_streaming_sharded_csr_end_to_end(mesh_runs, config):
    for r in _case(mesh_runs(config), "stream"):
        assert r["failed"]
        assert r["oracle_same"], "streamed labels != single-host oracle"
        assert r["resume_same"] and r["resume_bitwise"]
        assert r["batches"] == 4 and r["cards"] == 512.0


# ---------------------------------------------------------------------------
# the inner loop on a world of threads: where K_ll @ H comes from
# ---------------------------------------------------------------------------


class _ThreadWorld:
    """A fake mesh whose ranks are threads of this process: stands in for
    ``distributed/inner.py``'s ``axis_rank``, ``axis_size``,
    ``all_gather`` and ``all_reduce`` (sums in rank order)."""

    def __init__(self, shape: dict):
        import threading
        self.shape, self.names = shape, tuple(shape)
        self.local = threading.local()
        self.lock = threading.Lock()
        self.groups = {}

    def _axes(self, axes):
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def size(self, mesh, axes):
        return math.prod(self.shape[a] for a in self._axes(axes))

    def rank(self, mesh, axes):
        r = 0
        for a in self._axes(axes):
            r = r * self.shape[a] + self.local.coords[a]
        return r

    def _exchange(self, t, axes):
        import threading
        axes = self._axes(axes)
        key = (axes, tuple(self.local.coords[a] for a in self.names
                           if a not in axes))
        n = self.size(None, axes)
        with self.lock:
            bar, slots = self.groups.setdefault(
                key, (threading.Barrier(n, timeout=60), [None] * n))
        slots[self.rank(None, axes)] = t
        bar.wait()
        got = list(slots)
        bar.wait()
        return got

    def all_gather(self, t, mesh, axes):
        return torch.cat(self._exchange(t, axes))

    def all_reduce(self, t, mesh, axes):
        parts = self._exchange(t, axes)
        out = parts[0].clone()
        for p in parts[1:]:
            out = out + p
        return out

    def run(self, fn):
        """``fn()`` on every rank, each in a thread -> results in rank
        order."""
        import itertools
        import threading
        coords = [dict(zip(self.names, c)) for c in itertools.product(
            *(range(v) for v in self.shape.values()))]
        out, errors = [None] * len(coords), []

        def body(i):
            self.local.coords = coords[i]
            try:
                out[i] = fn()
            except Exception:
                errors.append(traceback.format_exc())
        threads = [threading.Thread(target=body, args=(i,))
                   for i in range(len(coords))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=DEADLINE)
        assert not any(t.is_alive() for t in threads), "a rank hung"
        assert not errors, errors[0]
        return out


#: world -> (mesh shape, the inner loop's layout)
THREAD_WORLDS = {"1d-2": ({"data": 2}, "1d"), "1d-3": ({"data": 3}, "1d"),
                 "2d-2x2": ({"data": 2, "model": 2}, "2d")}


@pytest.mark.parametrize("landmarks", ["all", "some"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", list(THREAD_WORLDS))
def test_inner_loop_on_thread_worlds(monkeypatch, world, mode, landmarks):
    """On 1-D worlds of 2 and 3 ranks a rank builds ONE Gram block a batch
    and takes K_ll @ H from its own landmark rows of K_xl @ H; on the 2-D
    layout it still builds its K_ll block beside it. The batch is padded
    with ghost rows to the mesh, the landmarks are every padded row or a
    sorted random subset that straddles the row blocks. With the loop cut
    to its prologue, the synced g is the single host's g contracted from a
    K_ll block (f32 rounding); run to its fixpoint, the labels are the
    single-host inner loop's on the padded batch."""
    import repro_torch.distributed.inner as dinner
    from repro_torch.core import KernelSpec
    from repro_torch.core.engine import (GramEngine, engine_stats,
                                         resolve_engine)
    from repro_torch.core.kkmeans import kkmeans_fit
    from repro_torch.distributed import ghost_row_ids
    shape, layout = THREAD_WORLDS[world]
    fake = _ThreadWorld(shape)
    for name in ("rank", "size"):
        monkeypatch.setattr(dinner, f"axis_{name}", getattr(fake, name))
    for name in ("all_gather", "all_reduce"):
        monkeypatch.setattr(dinner, name, getattr(fake, name))
    builds = []
    real_prepare = GramEngine.prepare

    def prepare(self, spec, x, y):
        if hasattr(fake.local, "coords"):       # on a rank
            builds.append((fake.rank(None, fake.names), x.shape[0]))
        return real_prepare(self, spec, x, y)
    monkeypatch.setattr(GramEngine, "prepare", prepare)

    rng = np.random.default_rng(2)
    n, c, d_size = 205, 4, shape["data"]
    x = rng.normal(size=(n, 6)).astype(np.float32)
    pad = np.concatenate([np.arange(n), ghost_row_ids(n, d_size)])
    n_pad = len(pad)
    l_idx = (np.arange(n_pad) if landmarks == "all" else
             np.sort(rng.choice(n, 60, replace=False)))
    x, u0 = torch.from_numpy(x[pad]), torch.from_numpy(
        rng.integers(0, c, n).astype(np.int32)[pad])
    wgt = torch.ones(n_pad)
    wgt[n:] = 0.0
    l_idx = torch.from_numpy(l_idx).long()
    spec = KernelSpec("rbf", gamma=0.2)
    diag = spec.diag(x)
    rows = n_pad // d_size

    def fit(max_iters):
        cfg = _inner_cfg(layout, n_clusters=c, kernel=spec, engine=mode,
                         max_iters=max_iters)

        def rank():
            blk = slice(fake.rank(None, "data") * rows,
                        (fake.rank(None, "data") + 1) * rows)
            return dinner._inner_local(None, x[blk], x[l_idx], l_idx,
                                       diag[blk], u0[blk], wgt[blk],
                                       cfg=cfg)
        return fake.run(rank)

    first = fit(0)
    eng = resolve_engine(mode)
    op_xl = real_prepare(eng, spec, x, x[l_idx])
    block = real_prepare(eng, spec, x[l_idx], x[l_idx])
    _, g, counts = engine_stats(eng, spec, op_xl, block, u0[l_idx],
                                u0[l_idx], c)
    for r in first:
        assert torch.equal(r.counts, counts)
        np.testing.assert_allclose(r.g.numpy(), g.numpy(), rtol=1e-5)
    # one batch: K_xl on every rank, and K_ll [|L|, |L|/M] on 2-D only
    want = [(r, rows) for r in range(len(first))]
    if layout == "2d":
        want += [(r, len(l_idx)) for r in range(len(first))]
    assert sorted(builds) == sorted(want)

    host = kkmeans_fit(x, l_idx, diag, u0, spec=spec, n_clusters=c,
                       engine=mode)
    for r in fit(100):
        assert torch.equal(r.labels, host.labels)
        np.testing.assert_allclose(r.g.numpy(), host.g.numpy(), atol=1e-4)


def test_make_test_mesh_names_the_sizes(tmp_path):
    """The default split of a world of one, and the error naming the sizes
    when the axes do not multiply to the world."""
    from repro_torch.distributed import (axis_size, ghost_row_ids,
                                         make_test_mesh, row_axes_of)

    def body():
        mesh = make_test_mesh(device="cpu")
        with pytest.raises(ValueError, match="needs 4 devices, have 1"):
            make_test_mesh({"data": 2, "model": 2}, device="cpu")
        return (tuple(mesh.mesh_dim_names), row_axes_of(mesh),
                axis_size(mesh, ("data", "model")))
    names, rows, size = run_in_process(body, str(tmp_path))
    assert names == ("data", "model") and rows == ("data",) and size == 1
    assert list(ghost_row_ids(3, 8)) == [0, 1, 2, 0, 1]
    assert list(ghost_row_ids(8, 4)) == []
    with pytest.raises(ValueError, match="empty batch"):
        ghost_row_ids(0, 4)


def test_production_mesh_needs_its_world(tmp_path):
    from repro_torch.launch.mesh import data_axes, make_production_mesh

    def body():
        for multi in (False, True):
            with pytest.raises(ValueError, match="ranks, have 1"):
                make_production_mesh(multi_pod=multi, device="cpu")
    run_in_process(body, str(tmp_path))
    assert data_axes(True) == ("pod", "data")
