"""Batch staging on a producer thread: the host side of the paper's
producer/consumer scheme (§3.3, Fig.3), the port of ``repro/data/loader.py``.

A background thread stages batch i+1 while the card runs the inner loop on
batch i. On the card the producer's default stage copies a host batch into
pinned memory and issues a ``non_blocking`` host-to-device copy on a copy
stream of its own, then records an event after the copy. The consumer
makes its current stream wait on that event before it hands the batch on,
and calls ``record_stream`` on every tensor of the batch, so the caching
allocator does not give the memory back to the copy stream while the fit
still reads it. A ``CSRBatch`` is staged tensor by tensor, so its bytes on
the bus are O(nnz). Without a producer thread (``prefetch=0``, as
``fit_dataset`` runs) the compute stream would wait on the copy at once,
so there the stage is the plain copy, ``to_device``. On the CPU
(``device="cpu"``) the stage is the dtype cast alone. A batch already on
the device is not copied.

Lifecycle: the producer is a daemon thread feeding a bounded queue. A
consumer that stops early (an error, a ``break``) must call ``close()``
(or use the context manager): it sets a stop flag and drains the queue
until the thread exits, and it is idempotent. A producer exception is
re-raised in the consumer.

``BatchSource`` is the one handle the fit loops consume: any iterable of
dense blocks or CSR mini-batches (a list, a generator, a ragged chunk
stream through ``from_stream``), with a host-side ``skip`` for resume
(skipped batches are never staged) and optional prefetch.

``recorder=`` (``repro_torch.obs``) watches the pipeline from both sides:
the producer times each stage call (``prefetch/stage_seconds``, by batch
``index``) and gauges the queue depth after every put
(``prefetch/queue_depth``); the consumer records how long it waited for
each batch (``prefetch/starve_seconds``). A shallow queue and a waiting
consumer mean ingestion, not the fit, is the bottleneck. Without a
producer thread the stage is timed in the consumer (``sync=True``).
``stage_seconds`` is host time around the stage call: on the card's
pinned ``DeviceStage`` that is the copy into pinned memory and the
enqueue of the asynchronous copy, not the copy itself, which the
consumer's stream waits for in ``arrive``.
"""
from __future__ import annotations

import contextlib
import functools
import queue
import threading
import time
from typing import Callable, Iterable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs import resolve as resolve_recorder
from repro_torch.obs.trace import span

from .sparse import CSRBatch, as_csr, is_sparse


@contextlib.contextmanager
def closing_source(batches):
    """The fit loops' consume rule: whatever happens inside, a closable
    batch source (``BatchSource``, ``PrefetchLoader``) is closed on exit,
    so its producer thread never outlives the fit. ``close()`` is
    idempotent, so nested entry points may each apply this."""
    try:
        yield batches
    finally:
        close = getattr(batches, "close", None)
        if callable(close):
            close()


def to_device(batch, device: torch.device, dtype=torch.float32):
    """A batch as the fit loops take it: a ``CSRBatch`` on ``device``, or a
    dense tensor of ``dtype`` there. A tensor already on the device in that
    dtype is returned as it is, not copied or cast again."""
    if is_sparse(batch):
        return as_csr(batch).to(device)
    return torch.as_tensor(batch, dtype=dtype).to(device)


class _InFlight(NamedTuple):
    """A staged batch whose copy the consumer's stream must wait for."""
    batch: object
    event: torch.cuda.Event


def _host_tensor(a, dtype) -> torch.Tensor:
    t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
    return t.to(dtype)


def _on_card(batch) -> bool:
    if isinstance(batch, CSRBatch):
        return batch.device.type == "cuda"
    return torch.is_tensor(batch) and batch.is_cuda


class DeviceStage:
    """The default stage of a batch onto ``device``. On the card: the host
    tensors are copied into pinned memory and on to the card by a
    ``non_blocking`` copy on this stage's own stream; the result carries
    the event recorded after the copy (``arrive`` waits on it). On the
    CPU: the dtype cast alone."""

    def __init__(self, device, dtype=torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def __call__(self, batch):
        if self.stream is None or _on_card(batch):
            return to_device(batch, self.device, self.dtype)
        if is_sparse(batch):
            b = as_csr(batch)
            host, shape = b.tensors(), b.shape
        else:
            host, shape = (_host_tensor(batch, self.dtype),), None
        pinned = [t.pin_memory() for t in host]      # one host copy
        with torch.cuda.stream(self.stream):
            staged = [t.to(self.device, non_blocking=True) for t in pinned]
            ev = torch.cuda.Event()
            ev.record(self.stream)
        return _InFlight(staged[0] if shape is None
                         else CSRBatch(*staged, shape), ev)


def arrive(item):
    """The consumer's side of a staged batch: make the current stream wait
    for its copy and mark its tensors as used there. Anything but an
    in-flight batch is returned as it is."""
    if not isinstance(item, _InFlight):
        return item
    batch = item.batch
    stream = torch.cuda.current_stream(batch.device)
    stream.wait_event(item.event)
    for t in (batch.tensors() if isinstance(batch, CSRBatch) else (batch,)):
        t.record_stream(stream)
    return batch


class PrefetchLoader:
    """Wrap a mini-batch iterable with ``depth`` batches of lookahead.

    ``stage`` maps a raw host batch to its device-resident form inside the
    producer thread; the default is a ``DeviceStage`` onto ``device``
    (``None``: the card, raising without one)."""

    _SENTINEL = object()

    def __init__(self, batches: Iterable, *, depth: int = 2, device=None,
                 dtype=torch.float32, stage: Optional[Callable] = None,
                 recorder=None):
        self._stage = stage if stage is not None else DeviceStage(device,
                                                                  dtype)
        self._rec = resolve_recorder(recorder)
        self._src = iter(batches)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that ``close()`` can interrupt: the timeout only
        bounds how long the thread parks before it looks at the stop flag
        again (a freed slot wakes it at once)."""
        delay = 0.05
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=delay)
                return True
            except queue.Full:
                delay = min(2.0 * delay, 0.5)
        return False

    def _produce(self) -> None:
        rec = self._rec
        try:
            for k, batch in enumerate(self._src):
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
                with span("obs:stage"):
                    staged = self._stage(batch)
                if rec.enabled:
                    rec.series("prefetch/stage_seconds",
                               time.perf_counter() - t0, index=k)
                if not self._put(staged):
                    return
                if rec.enabled:
                    rec.gauge("prefetch/queue_depth", self._q.qsize(),
                              index=k)
        except Exception as e:  # re-raised on the consumer's side
            self._err = e
        finally:
            self._put(self._SENTINEL)

    def __iter__(self) -> Iterator:
        rec = self._rec
        t_wait = None   # set when the consumer starts waiting for a batch
        while True:
            if rec.enabled and t_wait is None:
                t_wait = time.perf_counter()
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                # a closed producer (or one that died without its
                # sentinel) puts nothing more: an untimed get would hang
                if not (self._stop.is_set() or not self._thread.is_alive()):
                    continue
                # but it may have put its last batches and the sentinel
                # between the timed get and the check: take them first
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    if self._err is not None:
                        raise self._err
                    return
            if item is self._SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            if rec.enabled:
                rec.series("prefetch/starve_seconds",
                           time.perf_counter() - t_wait)
                t_wait = None
            yield arrive(item)

    def close(self, timeout: float = 10.0) -> None:
        """Stop the producer and release it (drain-on-close). Safe to call
        from a consumer that broke out mid-stream; idempotent."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:                     # unblock a producer stuck in put()
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.02)

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class BatchSource:
    """One handle over ingestion, host -> device.

    Wraps any mini-batch iterable (a list, a generator; dense [n, d] blocks
    or CSR batches) behind one lifecycle:

    * ``skip(k)``: drop the first k batches host-side before staging
      anything (resume: the committed prefix is never paid for);
    * ``stage=`` and ``prefetch=``: with ``prefetch > 0`` a
      ``PrefetchLoader`` stages on its thread (default: a ``DeviceStage``
      onto ``device``, ``None`` meaning the card); with 0 the stage runs in
      the consumer (default: ``to_device``, the plain copy, since nothing
      could overlap a pinned one there);
    * ``recorder=``: the ``prefetch/*`` series (see the module docstring);
    * ``close()`` / the context manager: releases the producer thread. The
      fit loops close the source when they finish or fail, so a source is
      single-use; iterating it again closes the earlier producer first.

    Constructors: ``from_dataset`` stride/block-splits a resident dense
    array or CSR dataset; ``from_stream`` re-chunks a ragged dense/CSR
    chunk stream (``sampling.stream_blocks``).
    """

    def __init__(self, batches: Iterable, *, device=None,
                 dtype=torch.float32, stage: Optional[Callable] = None,
                 prefetch: int = 0, skip: int = 0, recorder=None):
        self._batches = batches
        self._rec = resolve_recorder(recorder)
        self._prefetch = int(prefetch)
        if stage is None:
            dev = resolve_device(device)
            stage = (DeviceStage(dev, dtype) if self._prefetch > 0 else
                     functools.partial(to_device, device=dev, dtype=dtype))
        self._stage = stage
        self._skip = int(skip)
        self._loader: Optional[PrefetchLoader] = None

    @classmethod
    def from_dataset(cls, x, n_batches: int, strategy: str = "stride",
                     **kw) -> "BatchSource":
        """Split a resident dataset (dense [n, d] or a CSR batch)."""
        from .sampling import batch_indices, split_batches
        from .sparse import split_csr
        if is_sparse(x):
            parts = split_csr(as_csr(x), n_batches, strategy=strategy)
        elif torch.is_tensor(x):          # split where the tensor lies
            parts = [x[torch.from_numpy(idx).to(x.device)] for idx in
                     batch_indices(len(x), n_batches, strategy)]
        else:
            parts = split_batches(np.asarray(x), n_batches,
                                  strategy=strategy)
        return cls(parts, **kw)

    @classmethod
    def from_stream(cls, chunks: Iterable, batch_size: int,
                    **kw) -> "BatchSource":
        """Re-chunk a ragged dense/CSR chunk stream into block batches."""
        from .sampling import stream_blocks
        return cls(stream_blocks(iter(chunks), batch_size), **kw)

    def skip(self, n_batches: int) -> "BatchSource":
        """Drop the first ``n_batches`` host-side (resume). Returns self."""
        self._skip += int(n_batches)
        return self

    def __iter__(self) -> Iterator:
        it = iter(self._batches)
        try:
            for _ in range(self._skip):
                next(it)
        except StopIteration:
            return
        if self._prefetch > 0:
            self.close()   # iterating again must not orphan a producer
            self._loader = PrefetchLoader(it, depth=self._prefetch,
                                          stage=self._stage,
                                          recorder=self._rec)
            yield from self._loader
        else:
            for k, b in enumerate(it):
                t0 = time.perf_counter()
                staged = self._stage(b)
                if self._rec.enabled:
                    self._rec.series("prefetch/stage_seconds",
                                     time.perf_counter() - t0, index=k,
                                     sync=True)
                yield arrive(staged)

    def close(self) -> None:
        if self._loader is not None:
            self._loader.close()
            self._loader = None

    def __enter__(self) -> "BatchSource":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
