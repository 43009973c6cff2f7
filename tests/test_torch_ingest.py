"""Ingestion in the port (``repro_torch.data.sampling.stream_blocks``,
``repro_torch.data.loader``) against the JAX package's
(``repro.data.sampling``, ``repro.data.loader``) on the CPU.

``stream_blocks`` must cut the reference's batches from the same ragged
dense, CSR and mixed streams (equal rows, CSR where the reference gives
CSR) and own every chunk on arrival. ``PrefetchLoader`` and
``BatchSource`` keep the reference's lifecycle: order, a producer error
re-raised in the consumer, an idempotent ``close()`` that leaves no live
thread (after an early ``break`` too), ``skip``, re-iteration. Fits through
a streamed source equal the fits of the offline block split bitwise, and a
fit resumed by ``skip`` with ``state=`` (and ``fmap=``) equals the
uninterrupted one bitwise. On the CPU the stage is the dtype cast; the
card's pinned stage is held in ``tests/test_torch_cuda.py``.
"""
import queue
import types

import numpy as np
import pytest
import torch

from repro.data import sparse as jsp
from repro.data.loader import BatchSource as JBatchSource
from repro.data.sampling import stream_blocks as j_stream_blocks
from repro_torch import convert
from repro_torch.approx import selectors
from repro_torch.core import KernelSpec, MiniBatchConfig, fit, fit_dataset
from repro_torch.data import sparse as tsp
from repro_torch.data import synthetic
from repro_torch.data.loader import (BatchSource, DeviceStage,
                                     PrefetchLoader, closing_source,
                                     to_device)
from repro_torch.data.sampling import stream_blocks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops (small here) on one thread beside the suite's
    other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _dense(b):
    """A batch of either package -> dense numpy."""
    if isinstance(b, tsp.CSRBatch):
        return tsp.to_dense(b).numpy()
    if isinstance(b, jsp.CSRBatch):
        return jsp.to_dense(b)
    return np.asarray(b)


def _random_sparse(n, d, density, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32)
            * (rng.random((n, d)) < density))


def _cpu_source(batches, **kw):
    return BatchSource(batches, device="cpu", **kw)


# ---------------------------------------------------------------------------
# stream_blocks
# ---------------------------------------------------------------------------


_SIZES = [1, 7, 0, 2, 23, 5, 0, 1, 1, 12, 4]


@pytest.mark.parametrize("kind", ["dense", "csr", "mixed"])
@pytest.mark.parametrize("batch_size", [1, 4, 5, 56, 100])
def test_stream_blocks_matches_jax(kind, batch_size):
    """Ragged chunks straddling every batch boundary (sub-batch, exact,
    several batches, empty): the reference's batches, CSR where its are."""
    x = _random_sparse(sum(_SIZES), 6, 0.4, 3)
    bounds = np.cumsum([0] + _SIZES)
    csr = jsp.csr_from_dense(x)

    def chunks():
        for k, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
            if kind == "dense" or (kind == "mixed" and k % 2):
                yield x[a:b]
            else:
                yield jsp.slice_rows(csr, int(a), int(b))

    mine = list(stream_blocks(chunks(), batch_size))
    theirs = list(j_stream_blocks(chunks(), batch_size))
    assert [len(b) for b in mine] == [len(b) for b in theirs]
    n = len(x)
    assert [len(b) for b in mine] == [batch_size] * (n // batch_size) + (
        [n % batch_size] if n % batch_size else [])
    for a, b in zip(mine, theirs):
        assert isinstance(a, tsp.CSRBatch) == isinstance(b, jsp.CSRBatch)
        np.testing.assert_array_equal(_dense(a), _dense(b))
    np.testing.assert_array_equal(np.concatenate([_dense(b) for b in mine]),
                                  x)
    with pytest.raises(ValueError, match="batch_size"):
        list(stream_blocks(chunks(), 0))


@pytest.mark.parametrize("kind", ["numpy", "tensor", "csr"])
def test_stream_blocks_copies_out_of_reused_buffers(kind):
    """A reader that reuses one read buffer must not corrupt queued
    batches, also when a batch spans several pulls."""
    buf = np.empty((4, 2), np.float32)
    tbuf = torch.from_numpy(buf)

    def reader(n_chunks):
        for i in range(n_chunks):
            buf[:] = float(i + 1)
            yield {"numpy": buf, "tensor": tbuf,
                   "csr": tsp.csr_from_dense(tbuf)}[kind]

    out = list(stream_blocks(reader(3), 4))      # one batch per chunk
    for i, b in enumerate(out):
        np.testing.assert_array_equal(_dense(b),
                                      np.full((4, 2), i + 1, np.float32))
    out = list(stream_blocks(reader(4), 8))      # two pulls a batch
    want = np.repeat(np.arange(1.0, 5.0), 4).astype(np.float32)
    np.testing.assert_array_equal(
        np.concatenate([_dense(b) for b in out])[:, 0], want)


# ---------------------------------------------------------------------------
# PrefetchLoader and BatchSource
# ---------------------------------------------------------------------------


def _endless():
    i = 0
    while True:
        yield np.full((2, 2), i, np.float32)
        i += 1


def test_prefetch_loader_keeps_order_and_casts():
    batches = [np.full((4, 3), i, np.float64) for i in range(10)]
    batches.append(tsp.csr_from_dense(np.eye(3)))
    out = list(PrefetchLoader(batches, depth=3, device="cpu"))
    assert len(out) == 11
    for i, b in enumerate(out[:10]):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), batches[i])
    assert isinstance(out[10], tsp.CSRBatch)
    np.testing.assert_array_equal(tsp.to_dense(out[10]).numpy(), np.eye(3))


def test_prefetch_loader_reraises_producer_errors():
    def gen():
        yield np.ones((2, 2))
        raise RuntimeError("disk died")

    for make in (lambda g: PrefetchLoader(g, depth=2, device="cpu"),
                 lambda g: _cpu_source(g, prefetch=2)):
        with pytest.raises(RuntimeError, match="disk died"):
            list(make(gen()))
    with pytest.raises(RuntimeError, match="disk died"):
        list(_cpu_source(gen()))


@pytest.mark.parametrize("fails", [False, True])
def test_prefetch_loader_drains_a_producer_that_ends_during_a_get(
        monkeypatch, fails):
    """The producer puts its last batches and the sentinel, then exits,
    while the consumer's timed get runs out: the consumer must still take
    every batch (and re-raise the producer's error) instead of ending on
    the dead thread."""
    from repro_torch.data import loader as loader_mod

    class LateQueue(queue.Queue):
        """The first timed get returns empty only once the producer has
        put everything and exited."""
        owner = None

        def get(self, block=True, timeout=None):
            if timeout is not None and self.owner is not None:
                owner, self.owner = self.owner, None
                owner._thread.join()
                raise queue.Empty
            return super().get(block, timeout)

    monkeypatch.setattr(loader_mod, "queue", types.SimpleNamespace(
        Queue=LateQueue, Empty=queue.Empty, Full=queue.Full))

    def gen():
        for i in range(3):
            yield np.full((2, 2), i, np.float32)
        if fails:
            raise RuntimeError("disk died")

    loader = PrefetchLoader(gen(), depth=8, device="cpu")
    loader._q.owner = loader
    got = []
    if fails:
        with pytest.raises(RuntimeError, match="disk died"):
            for b in loader:
                got.append(b)
    else:
        got = list(loader)
    assert [float(b[0, 0]) for b in got] == [0.0, 1.0, 2.0]


def test_prefetch_loader_close_releases_the_producer():
    loader = PrefetchLoader(_endless(), depth=2, device="cpu")
    it = iter(loader)
    next(it)
    assert loader._thread.is_alive()      # parked on the full queue
    loader.close()
    assert not loader._thread.is_alive()
    loader.close()                        # idempotent
    assert len(list(it)) <= 2             # leftovers, then a clean end
    with PrefetchLoader(_endless(), depth=1, device="cpu") as loader:
        next(iter(loader))
    assert not loader._thread.is_alive()


def test_early_break_in_a_fit_leaves_no_live_thread():
    """A fit that fails mid-stream closes its source, and a consumer that
    breaks out closes it by ``closing_source``: no producer outlives
    either."""
    x = np.random.default_rng(0).normal(size=(400, 3)).astype(np.float32)
    src = BatchSource.from_dataset(x, 8, device="cpu", prefetch=2)
    threads = []

    def stop(state, i):
        threads.append(src._loader._thread)
        if i == 1:
            raise RuntimeError("stop")

    with pytest.raises(RuntimeError, match="stop"):
        fit(src, MiniBatchConfig(n_clusters=2, n_batches=8), device="cpu",
            checkpoint_cb=stop)
    assert src._loader is None and not threads[0].is_alive()
    src2 = _cpu_source(_endless(), prefetch=2)
    with closing_source(src2):
        for _ in src2:
            break
        loader = src2._loader
        assert loader._thread.is_alive()
    assert not loader._thread.is_alive()


@pytest.mark.parametrize("prefetch", [0, 2])
def test_batch_source_matches_jax(prefetch):
    """from_dataset splits as the reference does, skip() drops batches
    host-side, from_stream re-chunks; dense and CSR."""
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    for data, jdata in ((x, x), (tsp.csr_from_dense(x),
                                 jsp.csr_from_dense(x))):
        for strategy in ("stride", "block"):
            mine = list(BatchSource.from_dataset(
                data, 4, strategy, device="cpu", prefetch=prefetch))
            theirs = list(JBatchSource.from_dataset(jdata, 4, strategy))
            assert len(mine) == len(theirs) == 4
            for a, b in zip(mine, theirs):
                np.testing.assert_array_equal(_dense(a), _dense(b))
        got = list(BatchSource.from_dataset(data, 4, "block", device="cpu",
                                            prefetch=prefetch).skip(2))
        np.testing.assert_array_equal(
            np.concatenate([_dense(b) for b in got]), x[10:])
    chunks = [x[:3], x[3:16], x[16:]]
    with BatchSource.from_stream(chunks, 6, device="cpu",
                                 prefetch=prefetch) as src:
        assert [len(b) for b in src] == [6, 6, 6, 2]
    assert src._loader is None
    assert list(BatchSource.from_dataset(x, 4, device="cpu").skip(9)) == []


def test_batch_source_reiteration_closes_the_previous_producer():
    src = _cpu_source(_endless(), prefetch=2)
    next(iter(src))
    first = src._loader
    assert first._thread.is_alive()
    next(iter(src))
    assert not first._thread.is_alive()
    second = src._loader
    src.close()
    assert not second._thread.is_alive()


def test_device_none_means_the_card():
    """BatchSource, PrefetchLoader and the default stage raise without a
    card when given device=None."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    for make in (lambda: BatchSource([np.ones((2, 2))]),
                 lambda: BatchSource.from_dataset(np.ones((4, 2)), 2),
                 lambda: PrefetchLoader(iter([]), depth=1),
                 lambda: DeviceStage(None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_dataset(np.ones((8, 2), np.float32),
                    MiniBatchConfig(n_clusters=2, n_batches=2))


def test_to_device_keeps_a_tensor_already_there():
    t = torch.ones(3, 2)
    assert to_device(t, torch.device("cpu")) is t
    assert to_device(t.double(), torch.device("cpu")).dtype == torch.float32
    b = tsp.csr_from_dense(np.eye(3))
    assert to_device(b, torch.device("cpu")).data is b.data
    assert DeviceStage("cpu")(t) is t


@pytest.mark.parametrize("prefetch", [0, 2])
def test_batch_source_stages_in_the_producer_only(prefetch):
    """The default stage is the pinned DeviceStage on a producer thread
    (prefetch > 0) and the plain ``to_device`` copy in the consumer
    (prefetch = 0), where a pinned copy would have nothing to overlap."""
    src = BatchSource([np.ones((2, 2))], device="cpu", prefetch=prefetch)
    assert isinstance(src._stage, DeviceStage) == (prefetch > 0)
    (b,) = list(src)
    assert b.dtype == torch.float32 and b.device.type == "cpu"


# ---------------------------------------------------------------------------
# fits over sources: streamed == offline, resume by skip
# ---------------------------------------------------------------------------


def _ragged_cuts(n, b, seed=7):
    """Tab.2's streaming cut (``benchmarks/tab2_rcv1.py``): 3B random
    cut points from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    cuts = np.unique(rng.integers(0, n, size=3 * b))
    bounds = np.concatenate([[0], cuts, [n]])
    return [(int(a), int(z)) for a, z in zip(bounds[:-1], bounds[1:])
            if z > a]


@pytest.mark.parametrize("case", ["csr-sketch", "dense-exact",
                                  "dense-sketch-bf16"])
def test_streamed_fit_equals_the_offline_block_split(case):
    """The same rows as a ragged chunk stream through
    ``BatchSource.from_stream(prefetch=2)`` and as the offline block split
    (B | N): bitwise equal states and labels."""
    if case == "csr-sketch":
        xs, _ = synthetic.make_rcv1_sparse(600, vocab=300, n_classes=4,
                                           seed=2)
        data = xs
        chunks = [tsp.slice_rows(xs, a, z) for a, z in _ragged_cuts(600, 4)]
    else:
        x, _ = synthetic.make_blobs(600, 5, 4, seed=2)
        data = x
        chunks = [x[a:z] for a, z in _ragged_cuts(600, 4)]
    kw = dict(n_clusters=4, n_batches=4, sampling="block", seed=0)
    if case == "dense-exact":
        cfg = MiniBatchConfig(s=0.2, engine="fused",
                              kernel=KernelSpec("rbf", gamma=0.5), **kw)
    else:
        cfg = MiniBatchConfig(method="sketch", embed_dim=32,
                              kernel=KernelSpec("linear"),
                              precision="bf16" if "bf16" in case else "f32",
                              **kw)
    offline = fit_dataset(data, cfg, device="cpu")
    streamed = fit(BatchSource.from_stream(iter(chunks), 150, device="cpu",
                                           prefetch=2), cfg, device="cpu")
    assert [h.inner_iters for h in streamed.history] == [
        h.inner_iters for h in offline.history]
    for a, b in zip(streamed.state[:-1], offline.state[:-1]):
        assert torch.equal(a, b)
    assert torch.equal(streamed.predict(data), offline.predict(data))


@pytest.mark.parametrize("method", ["sketch", "exact"])
def test_resume_by_skip_is_bitwise_equal(method):
    """Stop after batch 2 (the checkpoint keeps the state), rebuild the
    source with skip(2), resume with state= (and fmap=): the uninterrupted
    fit's state and labels, bitwise."""
    xs, _ = synthetic.make_rcv1_sparse(480, vocab=200, n_classes=4, seed=4)
    if method == "exact":
        data = tsp.to_dense(xs)
        cfg = MiniBatchConfig(n_clusters=4, n_batches=4, s=0.5,
                              kernel=KernelSpec("rbf", gamma=1.0))
    else:
        data = xs
        cfg = MiniBatchConfig(n_clusters=4, n_batches=4, method="sketch",
                              embed_dim=32, kernel=KernelSpec("linear"))

    def source():
        return BatchSource.from_dataset(data, 4, device="cpu", prefetch=2)

    full = fit(source(), cfg, device="cpu")
    saved = {}

    def crash(state, i):
        saved[i] = state
        if i == 1:
            raise RuntimeError("lost the node")

    with pytest.raises(RuntimeError, match="lost the node"):
        fit(source(), cfg, device="cpu", checkpoint_cb=crash)
    state = saved[1]
    assert state.batches_done == 2
    resumed = fit(source().skip(2), cfg, device="cpu", state=state,
                  fmap=full.fmap)
    assert resumed.state.batches_done == 4
    for a, b in zip(resumed.state[:-1], full.state[:-1]):
        assert torch.equal(a, b)
    assert torch.equal(resumed.predict(data), full.predict(data))


def test_select_streaming_takes_and_closes_a_source():
    """select_streaming folds a BatchSource as it folds the list of its
    batches, closes it on exit (success or failure), and refuses a CSR
    first batch with the needs-dense-rows error."""
    x = np.random.default_rng(1).normal(size=(240, 5)).astype(np.float32)
    spec = KernelSpec("rbf", gamma=0.5)
    want, _ = selectors.select_streaming(
        "rls", 3, [x[i:i + 40] for i in range(0, 240, 40)], 12, spec,
        device="cpu")
    src = BatchSource.from_stream([x[:17], x[17:200], x[200:]], 40,
                                  device="cpu", prefetch=2)
    got, state = selectors.select_streaming("rls", 3, src, 12, spec,
                                            device="cpu")
    assert torch.equal(got, want) and int(state.folds) == 6
    assert src._loader is None
    csr = BatchSource([tsp.csr_from_dense(x[:40])], device="cpu",
                      prefetch=2)
    with pytest.raises(ValueError, match="dense"):
        selectors.select_streaming("uniform", 0, csr, 4, spec, device="cpu")
    assert csr._loader is None


def test_csr_conversion_carries_the_reference_batch():
    xs, _ = synthetic.make_rcv1_sparse(50, vocab=40, n_classes=3, seed=0)
    fields = convert.csr_to_numpy(xs)
    theirs = jsp.CSRBatch(**fields)
    back = convert.csr_from_numpy(theirs.data, theirs.indices,
                                  theirs.indptr, theirs.shape, "cpu")
    assert back.indptr.dtype == torch.int64
    np.testing.assert_array_equal(tsp.to_dense(back).numpy(),
                                  jsp.to_dense(theirs))
