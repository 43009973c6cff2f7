"""Checkpoints and elastic resume in the port (``repro_torch.ft``) against
the reference's ``repro.ft`` on the CPU.

The on-disk layout is the reference's: a checkpoint the reference's
``ElasticClusteringRunner`` wrote after batch 2 (on its one-device mesh)
resumes in the port's runner to the reference's uninterrupted result
within f32 tolerance, and the other way round. Across world sizes the
port's state does not depend on the mesh: an exact, an RFF and a CSR
sketch fit checkpointed after batch 2 on a world of 4 ((4, 1) mesh) and
resumed on a world of 2 ((2, 1)) equal the uninterrupted fit of a world of
1 bitwise; the resume re-plans for its two row shards. The spawned worlds
are the mesh tests' (``test_torch_mesh.spawn_world``: FileStore, one
thread a child, a 120 s deadline). A simulated failure closes the batch
source it was consuming.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from test_torch_mesh import _blobs, run_in_process, spawn_world

METHODS = ("exact", "rff", "sketch")


def _cfg(method, api, s=0.5):
    """The fit of each method, in the port's or the reference's config
    (``s``: the exact fit's landmark fraction)."""
    if api == "port":
        from repro_torch.core import KernelSpec, MiniBatchConfig
    else:
        from repro.core import KernelSpec, MiniBatchConfig
    if method == "exact":
        return MiniBatchConfig(n_clusters=4, n_batches=4, s=s,
                               kernel=KernelSpec("rbf", gamma=8.0), seed=0,
                               engine="fused")
    if method == "rff":
        return MiniBatchConfig(n_clusters=4, n_batches=4, method="rff",
                               embed_dim=16,
                               kernel=KernelSpec("rbf", gamma=8.0), seed=0)
    return MiniBatchConfig(n_clusters=4, n_batches=4, method="sketch",
                           embed_dim=64, kernel=KernelSpec("linear"), seed=0)


def _batches(method, api):
    """Four stride batches: blobs, or CSR documents for the sketch."""
    if method != "sketch":
        x, _ = _blobs(256, 7)
        return [x[i::4] for i in range(4)]
    if api == "port":
        from repro_torch.data.sparse import split_csr
        from repro_torch.data.synthetic import make_rcv1_sparse
    else:
        from repro.data.sparse import split_csr
        from repro.data.synthetic import make_rcv1_sparse
    xs, _ = make_rcv1_sparse(1024, vocab=2048, n_classes=4, seed=0)
    return split_csr(xs, 4, strategy="stride")


def _arrays(state) -> dict:
    """A state (the port's or the reference's) as numpy arrays by field."""
    return {k: np.asarray(v.cpu() if torch.is_tensor(v) else v)
            for k, v in state._asdict().items()}


# ---------------------------------------------------------------------------
# the port's runner, in a world of one here or in spawned worlds
# ---------------------------------------------------------------------------


def _port_run(method, ckdir, axes, fail_after=None, s=0.5):
    """The port's runner on a mesh of ``axes`` -> (state arrays, whether it
    failed, the re-plan's processor count)."""
    from repro_torch.distributed import make_test_mesh
    from repro_torch.ft import (CheckpointManager, ElasticClusteringRunner,
                                SimulatedFailure)
    mesh = make_test_mesh(axes, device="cpu")
    runner = ElasticClusteringRunner(_cfg(method, "port", s),
                                     CheckpointManager(ckdir))
    try:
        res = runner.run(mesh, _batches(method, "port"),
                         fail_after=fail_after)
        failed = False
    except SimulatedFailure as e:
        res, failed = e.partial, True
    return (_arrays(res.state), failed,
            None if runner.plan is None else runner.plan.p)


def _ft_child(rank, world, store, out_dir, jobs):
    import warnings
    warnings.simplefilter("ignore")
    torch.set_num_threads(1)
    import torch.distributed as dist
    from test_torch_mesh import _init
    _init(rank, world, store)
    got = [_port_run(*job) for job in jobs]
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(got, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def elastic_runs(tmp_path_factory):
    """method -> {world: the result of every rank}: the straight fit at
    world 1, the failed one at world 4, the resumed one at world 2; one
    spawn per world size runs every method."""
    base = tmp_path_factory.mktemp("elastic")
    out = {m: {} for m in METHODS}
    d = str(base / "w1")
    os.makedirs(d)
    got = run_in_process(lambda: [
        _port_run(m, str(base / f"straight-{m}"), {"data": 1, "model": 1})
        for m in METHODS], d)
    for m, r in zip(METHODS, got):
        out[m]["w1"] = [r]
    for world, axes, fail in ((4, {"data": 4, "model": 1}, 2),
                              (2, {"data": 2, "model": 1}, None)):
        d = str(base / f"w{world}")
        os.makedirs(d)
        jobs = [(m, str(base / f"ck-{m}"), axes, fail) for m in METHODS]
        ranks = spawn_world(_ft_child, world, (jobs,), d)
        for j, m in enumerate(METHODS):
            out[m][f"w{world}"] = [r[j] for r in ranks]
    return out


@pytest.mark.parametrize("method", METHODS)
def test_world4_checkpoint_resumes_on_world2_bitwise(elastic_runs, method):
    runs = elastic_runs[method]
    (want, _, _), = runs["w1"]
    for state, failed, _ in runs["w4"]:
        assert failed and int(state["batches_done"]) == 2
    for state, failed, replan in runs["w2"]:
        assert not failed and replan == 2     # re-planned for 2 row shards
        for k, v in want.items():
            assert np.array_equal(state[k], v), k


# ---------------------------------------------------------------------------
# the reference's checkpoints in the port, and the port's in the reference
# ---------------------------------------------------------------------------


def _ref_run(method, ckdir, fail_after=None):
    """The reference's runner on its one-device mesh; the exact fit at
    s = 1, whose landmarks need no draw after batch 0."""
    from repro.distributed import make_test_mesh
    from repro.ft.checkpoint import CheckpointManager
    from repro.ft.elastic import ElasticClusteringRunner, SimulatedFailure
    runner = ElasticClusteringRunner(_cfg(method, "ref", 1.0),
                                     CheckpointManager(ckdir))
    try:
        return runner.run(make_test_mesh(), _batches(method, "ref"),
                          fail_after=fail_after), False
    except SimulatedFailure as e:
        return e.partial, True


def _close(got: dict, want: dict):
    """Equal within f32 tolerance, field by field, after four batches."""
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)
    assert int(got["batches_done"]) == 4


@pytest.mark.parametrize("method", ["exact", "rff"])
def test_reference_checkpoint_resumes_in_the_port(tmp_path, method):
    want, _ = _ref_run(method, str(tmp_path / "straight"))
    ck = str(tmp_path / "ck")
    _, failed = _ref_run(method, ck, fail_after=2)
    assert failed
    got, failed, _ = run_in_process(
        lambda: _port_run(method, ck, {"data": 1, "model": 1}, s=1.0),
        str(tmp_path))
    assert not failed
    _close(got, _arrays(want.state))


@pytest.mark.parametrize("method", ["exact", "rff"])
def test_port_checkpoint_resumes_in_the_reference(tmp_path, method):
    ck = str(tmp_path / "ck")

    def port():
        straight = _port_run(method, str(tmp_path / "straight"),
                             {"data": 1, "model": 1}, s=1.0)
        failed = _port_run(method, ck, {"data": 1, "model": 1}, 2, 1.0)[1]
        return straight, failed
    (want, _, _), failed = run_in_process(port, str(tmp_path))
    assert failed
    got, failed = _ref_run(method, ck)
    assert not failed
    _close(_arrays(got.state), want)


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_gc(tmp_path):
    from repro_torch.ft import CheckpointManager
    cm = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(12.0).reshape(3, 4),
            "opt": {"m": torch.ones(5), "step": 7},
            "half": torch.linspace(0, 1, 6).to(torch.bfloat16)}
    for s in (1, 2, 3, 4):
        cm.save(s, tree, extra={"batch": s})
    assert cm.all_steps() == [3, 4]
    like = {"w": torch.zeros(1), "opt": {"m": torch.zeros(1), "step": 0},
            "half": torch.zeros(1, dtype=torch.bfloat16)}
    got = cm.restore(4, like)
    assert torch.equal(got["w"], tree["w"])
    assert torch.equal(got["opt"]["m"], tree["opt"]["m"])
    assert got["opt"]["step"] == 7
    assert got["half"].dtype == torch.bfloat16
    assert torch.equal(got["half"], tree["half"])
    assert cm.extra(4) == {"batch": 4}
    # the reference reads the port's files, bf16 included
    import ml_dtypes
    from repro.ft.checkpoint import CheckpointManager as JManager
    jgot = JManager(str(tmp_path)).restore(4, {
        "w": np.zeros(1), "opt": {"m": np.zeros(1), "step": np.zeros(())},
        "half": np.zeros(1, ml_dtypes.bfloat16)})
    np.testing.assert_array_equal(np.asarray(jgot["w"]), tree["w"].numpy())
    np.testing.assert_array_equal(
        np.asarray(jgot["half"]).astype(np.float32),
        tree["half"].float().numpy())


def test_checkpoint_atomic_no_partial_visible(tmp_path):
    """A crash mid-save (an orphan .tmp directory) stays invisible."""
    from repro_torch.ft import CheckpointManager
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"a": torch.ones(3)})
    os.makedirs(os.path.join(str(tmp_path), "step_000000002.tmp"))
    assert cm.all_steps() == [1] and cm.latest_step() == 1
    cm.save(2, {"a": torch.ones(3)})
    assert cm.latest_step() == 2


def test_selector_state_checkpoint_roundtrip(tmp_path):
    """A streaming selection's SelectorState, checkpointed mid-stream by the
    port, reads back in the port and in the reference, and the resumed fold
    selects the landmarks of the uninterrupted one."""
    from repro_torch.approx import selectors
    from repro_torch.core import KernelSpec
    from repro_torch.ft import CheckpointManager
    x, _ = _blobs(128, 3)
    blocks = [x[i * 64:(i + 1) * 64] for i in range(8)]
    spec = KernelSpec("rbf", gamma=8.0)
    cm = CheckpointManager(str(tmp_path))
    straight, _ = selectors.select_streaming(
        "rls", 5, blocks, 16, spec, device="cpu",
        checkpoint_cb=lambda st, i: cm.save(i, st) if i == 3 else None)
    st = cm.restore(3, selectors.state_like(2, device="cpu"))
    assert int(st.folds) == 4 and st.rows.shape == (256, 2)
    resumed, _ = selectors.select_streaming(
        "rls", 5, blocks[4:], 16, spec, state=st, device="cpu")
    assert torch.equal(straight, resumed)
    from repro.approx.selectors import state_like as j_state_like
    from repro.ft.checkpoint import CheckpointManager as JManager
    jst = JManager(str(tmp_path)).restore(3, j_state_like(2))
    np.testing.assert_array_equal(np.asarray(jst.rows), st.rows.numpy())
    np.testing.assert_array_equal(np.asarray(jst.gids), st.gids.numpy())


# ---------------------------------------------------------------------------
# the runner's lifecycle
# ---------------------------------------------------------------------------


class _Spy:
    """A batch source that records whether it was closed."""

    def __init__(self, batches):
        from repro_torch.data.loader import BatchSource
        self.src = BatchSource(batches, device="cpu", prefetch=2)
        self.closed = False

    def __iter__(self):
        return iter(self.src)

    def skip(self, k):
        self.src.skip(k)
        return self

    def close(self):
        self.closed = True
        self.src.close()


@pytest.mark.parametrize("method", ["exact", "rff"])
def test_simulated_failure_closes_the_source(tmp_path, method, monkeypatch):
    import repro_torch.ft.elastic as elastic
    monkeypatch.setattr(elastic, "BatchSource", _Spy)
    spy = _Spy(_batches(method, "port"))

    def body():
        from repro_torch.distributed import make_test_mesh
        from repro_torch.ft import (CheckpointManager,
                                    ElasticClusteringRunner,
                                    SimulatedFailure)
        runner = ElasticClusteringRunner(
            _cfg(method, "port"), CheckpointManager(str(tmp_path / "ck")))
        with pytest.raises(SimulatedFailure) as err:
            runner.run(make_test_mesh(device="cpu"), spy, fail_after=1)
        return err.value.partial.state.batches_done
    assert run_in_process(body, str(tmp_path)) == 1
    assert spy.closed and spy.src._loader is None


def test_replan_refuses_a_mesh_too_small(tmp_path):
    """Resuming on fewer row shards prices the committed batch on them; a
    rank that cannot hold it refuses to resume, naming the bytes."""
    from repro_torch.core.memory import MachineSpec
    from repro_torch.ft import CheckpointManager, ElasticClusteringRunner
    cfg = _cfg("exact", "port")
    runner = ElasticClusteringRunner(cfg, CheckpointManager(str(tmp_path)),
                                     machine=MachineSpec(memory_bytes=1e3))
    runner._replan({"rows": 256, "d_rows": 2, "shards": 4}, 4)
    assert runner.plan is None                  # same mesh: no re-plan
    with pytest.raises(ValueError, match="2 row shards"):
        runner._replan({"rows": 256, "d_rows": 2, "shards": 4}, 2)
    assert runner.plan.p == 2
