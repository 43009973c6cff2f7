"""Continuous-batching assignment service over a frozen predict artifact,
the port of ``repro/serving/assign.py``.

Requests arrive with 1..N query rows. Every request is packed into a small
fixed ladder of shape buckets (``DEFAULT_BUCKETS`` rows), so the service
runs ``len(buckets)`` programs in all. On the card each bucket's program is
one captured ``torch.cuda.CUDAGraph`` (the port's counterpart of the
reference's AOT-compiled programs): ``AssignService.warm`` runs every
bucket once eagerly, which builds the kernels, the occupancy figures and
the launch geometry, then captures the bucket over a static padded input
and static outputs. A replay launches what the capture recorded with no
Python on the way, which is what a one-row request is made of. On the CPU
each bucket's program is the plain eager call. ``compiled_programs`` is
the program count either way.

Padding safety: padded rows are zeros, and each row's argmin depends on
that row alone, so padding never changes a real row's label (a test fills
the padding with garbage to show it); real labels are sliced back.

Ingestion:

* dense rows of the fused kinds run ``ops.predict_assign`` (the
  ``embed_assign`` / ``sketch_assign`` kernels); the exact kind runs
  ``core.minibatch.predict`` (``kernel_matrix``'s column body and an
  argmin) and TensorSketch its plain FFT path, as in the reference;
* CSR rows to the sketch kinds run the O(nnz) program (``run_csr_bucket``:
  the map's sort-and-segment-sum embedding, ``approx/sketch.py``, then the
  plain score and argmin): rows pad to the bucket and stored slots to a
  power-of-two rung (``_pad_csr``, slack slots holding zeros that scatter
  nothing); under bf16 the stored values are rounded to bf16 and summed in
  f32. A CSR tick runs **eagerly, on the card too: no CUDA graph**, since
  its shapes follow the nnz rung; ``compiled_programs`` counts the dense
  buckets' programs only. A tick packs consecutive FIFO heads of one kind
  (dense or CSR), so queued CSR requests fill the buckets the offline
  predict's chunks fill;
* CSR rows to rff, Nystrom and exact artifacts have no O(nnz) embedding:
  they are densified at ingestion (row by row, exactly) and take the dense
  bucket path, on the card the ``embed_assign`` / ``kernel_matrix``
  kernels.

The flight recorder (``recorder=``, ``repro_torch.obs``) gets the
reference's records: ``serve/warm`` (the programs' build seconds),
``serve/submitted`` and ``serve/rejected`` counters, the ``serve/queue_rows``
gauge, and per completed request its ``serve/queue_seconds`` and
``serve/compute_seconds`` series and a ``serve/request`` event (rows,
bucket, queue / compute / total seconds). Every hook runs on the host
around a program's call, never inside a graph's capture (a hook recorded
there would run once at capture and never at a replay), so the graph
count is the same with the recorder on or off.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.approx.sketch import SKETCH_KINDS
from repro_torch.core.minibatch import predict as exact_predict
from repro_torch.data.sparse import (CSRBatch, as_csr, concat_csr,
                                     is_sparse, pad_csr_capacity, slice_rows,
                                     stored, to_dense)
from repro_torch.kernels import ops
from repro_torch.kernels.precision import resolve_precision
from repro_torch.obs import resolve as resolve_recorder

from .artifact import FrozenArtifact

#: the shape ladder: requests pad to the smallest bucket that fits; larger
#: requests chunk by the largest
DEFAULT_BUCKETS = (1, 8, 64, 512)


class QueueFull(RuntimeError):
    """Admission control: the queue holds ``max_queue_rows`` already."""


def bucket_for(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest ladder bucket holding ``n`` rows."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} rows exceed the largest bucket {buckets[-1]}")


def run_bucket(art: FrozenArtifact, xp: torch.Tensor) -> torch.Tensor:
    """One padded dense bucket [b, d] f32 on the artifact's device ->
    labels [b] int32 there. Reads the artifact and derives nothing."""
    a, rt, s = art.arrays, art.runtime, art.statics
    if art.kind == "exact":
        return exact_predict(xp, a["medoids"], a["medoid_diag"],
                             spec=rt["spec"], device=xp.device)
    if art.kind == "tensorsketch":
        return ops.score_assign(rt["fmap"](xp), a["v"], a["csq"])[0]
    if art.kind == "sketch":
        return ops.predict_assign(xp, a["h"], a["sign"], a["v"], a["csq"],
                                  map_kind="sketch", precision=art.precision,
                                  tables=rt.get("tables"))[0]
    aux = rt["b"] if art.kind == "rff" else a["aux"]
    return ops.predict_assign(
        xp, a["w"], aux, a["v"], a["csq"], map_kind=s["map_kind"],
        gamma=float(s["gamma"]), coef0=float(s["coef0"]),
        degree=int(s["degree"]), scale=float(s["scale"]),
        precision=art.precision)[0]


def run_csr_bucket(art: FrozenArtifact, piece: CSRBatch) -> torch.Tensor:
    """One padded CSR bucket of a sketch kind on the artifact's device ->
    labels [b] int32 there: the map's O(nnz) embedding of the stored
    values (rounded to the tile dtype first, summed in f32), then the
    plain score and argmin."""
    p = resolve_precision(art.precision)
    if p.tile != "f32":
        piece = CSRBatch(p.cast_tiles(piece.data).to(torch.float32),
                         piece.indices, piece.indptr, piece.shape)
    a = art.arrays
    return ops.score_assign(art.runtime["fmap"](piece), a["v"],
                            a["csq"])[0]


def _pad_csr(piece: CSRBatch, rows: int) -> CSRBatch:
    """Pad a CSR piece to ``rows`` bucket rows and a power-of-two stored-
    slot capacity (the nnz rung)."""
    k = stored(piece)
    cap = 1 << max(0, (max(k, 1) - 1).bit_length())
    return pad_csr_capacity([piece], rows=rows, nnz_multiple=cap)[0]


def _check_width(art: FrozenArtifact, shape) -> None:
    if len(shape) != 2 or shape[1] != art.in_dim:
        raise ValueError(f"queries must be [n, {art.in_dim}], got "
                         f"{tuple(shape)}")


def _ladder(buckets) -> tuple[int, ...]:
    return tuple(sorted({int(b) for b in buckets}))


def predict(art: FrozenArtifact, x, *,
            buckets: tuple[int, ...] = DEFAULT_BUCKETS) -> torch.Tensor:
    """Offline bucket-routed prediction (the ``FitResult.predict`` path):
    chunk ``x`` by the largest bucket, zero-pad the rest to the smallest
    bucket that fits, run each bucket eagerly and slice the real labels
    back -> [n] int32 on the artifact's device. A CSR batch runs the O(nnz)
    program for the sketch kinds and is densified for the others."""
    buckets = _ladder(buckets)
    if is_sparse(x):
        x = as_csr(x)
        _check_width(art, x.shape)
        if art.kind in SKETCH_KINDS:
            return _predict_csr(art, x, buckets)
        x = to_dense(x)
    x = torch.as_tensor(x, dtype=torch.float32).to(art.device)
    _check_width(art, x.shape)
    n = x.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=art.device)
    start = 0
    while start < n:
        take = min(buckets[-1], n - start)
        b = bucket_for(take, buckets)
        xp = F.pad(x[start:start + take], (0, 0, 0, b - take))
        out[start:start + take] = run_bucket(art, xp)[:take]
        start += take
    return out


def _predict_csr(art: FrozenArtifact, x: CSRBatch,
                 buckets: tuple[int, ...]) -> torch.Tensor:
    n = x.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=art.device)
    start = 0
    while start < n:
        take = min(buckets[-1], n - start)
        piece = _pad_csr(slice_rows(x, start, start + take),
                         bucket_for(take, buckets))
        out[start:start + take] = run_csr_bucket(
            art, piece.to(art.device))[:take]
        start += take
    return out


class _EagerProgram:
    """A bucket's program on the CPU: the plain call."""

    def __init__(self, art: FrozenArtifact):
        self.art = art

    def __call__(self, xp: np.ndarray) -> np.ndarray:
        xp = torch.from_numpy(xp).to(self.art.device)
        return run_bucket(self.art, xp).cpu().numpy()


class _GraphProgram:
    """A bucket's program on the card: one captured CUDA graph over a
    static input ``x`` [bucket, d] and the labels it writes, fed from and
    read into pinned host buffers. A replay adds to ``ops.LAUNCHES`` the
    kernel launches its capture recorded: each replay launches them."""

    def __init__(self, art: FrozenArtifact, bucket: int, pool):
        dev = art.device
        self.host_in = torch.zeros((bucket, art.in_dim), pin_memory=True)
        self.host_out = torch.empty((bucket,), dtype=torch.int32,
                                    pin_memory=True)
        self.x = torch.zeros((bucket, art.in_dim), device=dev)
        # one eager run first, off the capture: it builds the library, the
        # kernels' attributes and occupancy figures, the cuFFT plans
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run_bucket(art, self.x)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = dict(ops.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.out = run_bucket(art, self.x)
        self.launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
        for k, v in before.items():       # the capture launched nothing
            ops.LAUNCHES[k] = v

    def __call__(self, xp: np.ndarray) -> np.ndarray:
        self.host_in.numpy()[:] = xp
        self.x.copy_(self.host_in, non_blocking=True)
        self.graph.replay()
        for k, v in self.launches.items():
            ops.LAUNCHES[k] += v
        self.host_out.copy_(self.out, non_blocking=True)
        torch.cuda.current_stream(self.x.device).synchronize()
        return self.host_out.numpy().copy()


@dataclasses.dataclass(frozen=True)
class AssignServeConfig:
    """Knobs of the service: the bucket ladder, admission control and
    whether construction builds every bucket's program (``warm``)."""
    buckets: tuple[int, ...] = DEFAULT_BUCKETS
    max_queue_rows: int = 4096
    warm: bool = True

    def __post_init__(self):
        if not self.buckets:
            raise ValueError("need at least one bucket")
        object.__setattr__(self, "buckets", _ladder(self.buckets))


@dataclasses.dataclass
class _Request:
    uid: int
    x: np.ndarray | CSRBatch  # [n, d] rows
    n: int
    t_submit: float
    labels: np.ndarray   # [n] int32, filled as ticks complete rows
    filled: int = 0


class AssignService:
    """Continuous-batching assignment server over a ``FrozenArtifact``.

    ``submit`` enqueues a request (admission-controlled); ``step`` packs
    the FIFO head into the smallest bucket that fits, runs one program and
    scatters the labels back, a request possibly across several ticks;
    ``drain`` ticks until the queue is empty. Runs on the artifact's
    device."""

    def __init__(self, artifact: FrozenArtifact,
                 cfg: AssignServeConfig = AssignServeConfig(), *,
                 recorder=None):
        self.artifact = artifact
        self.cfg = cfg
        self.rec = resolve_recorder(recorder)
        self.warm_seconds = 0.0
        self._queue: collections.deque[_Request] = collections.deque()
        self._pending_rows = 0
        self._uid = 0
        self._programs: dict = {}
        self._pool = (torch.cuda.graph_pool_handle()
                      if artifact.device.type == "cuda" else None)
        if cfg.warm:
            self.warm()

    # -- programs -----------------------------------------------------------

    @property
    def compiled_programs(self) -> int:
        """Resident programs: one per bucket of the ladder once warm."""
        return len(self._programs)

    def warm(self) -> None:
        """Build one program per bucket (on the card: run it once, then
        capture it), so the first request pays no build."""
        t0 = time.perf_counter()
        for b in self.cfg.buckets:
            self._program(b)
        self.warm_seconds = time.perf_counter() - t0
        self.rec.event("serve/warm", seconds=self.warm_seconds,
                       programs=len(self._programs))

    def _program(self, bucket: int):
        if bucket not in self._programs:
            self._programs[bucket] = (
                _GraphProgram(self.artifact, bucket, self._pool)
                if self._pool is not None else _EagerProgram(self.artifact))
        return self._programs[bucket]

    # -- queue --------------------------------------------------------------

    def submit(self, x) -> int:
        """Enqueue one request of rows [n, d], dense or CSR; returns its
        uid. CSR rows stay sparse for the sketch kinds and are densified
        here for the others. Raises ``QueueFull`` when admission would
        exceed ``max_queue_rows`` pending rows."""
        if is_sparse(x):
            x = as_csr(x).to("cpu")
            _check_width(self.artifact, x.shape)
            if self.artifact.kind not in SKETCH_KINDS:
                x = to_dense(x).numpy()
        else:
            x = (x.detach().to("cpu", torch.float32).numpy()
                 if torch.is_tensor(x) else np.asarray(x, np.float32))
            _check_width(self.artifact, x.shape)
        n = x.shape[0]
        if n == 0:
            raise ValueError("empty request")
        if self._pending_rows + n > self.cfg.max_queue_rows:
            self.rec.counter("serve/rejected", rows=n)
            raise QueueFull(f"{self._pending_rows} rows pending + {n} > "
                            f"max_queue_rows={self.cfg.max_queue_rows}")
        self._uid += 1
        self._queue.append(_Request(self._uid, x, n, time.perf_counter(),
                                    np.empty((n,), np.int32)))
        self._pending_rows += n
        self.rec.counter("serve/submitted", rows=n)
        self.rec.gauge("serve/queue_rows", self._pending_rows)
        return self._uid

    def step(self) -> dict[int, np.ndarray]:
        """One scheduler tick -> {uid: labels} of the requests it
        completed."""
        if not self._queue:
            return {}
        bmax = self.cfg.buckets[-1]
        sparse = isinstance(self._queue[0].x, CSRBatch)
        items, total = [], 0
        for req in self._queue:    # FIFO heads of one kind, partial allowed
            if total >= bmax or isinstance(req.x, CSRBatch) != sparse:
                break
            take = min(req.n - req.filled, bmax - total)
            items.append((req, req.filled, take))
            total += take
        bucket = bucket_for(total, self.cfg.buckets)
        if sparse:
            piece = _pad_csr(concat_csr([slice_rows(req.x, s, s + t)
                                         for req, s, t in items]), bucket)
            t0 = time.perf_counter()
            labels = run_csr_bucket(
                self.artifact, piece.to(self.artifact.device))
            labels = labels.cpu().numpy()[:total]
        else:
            xp = np.zeros((bucket, self.artifact.in_dim), np.float32)
            ofs = 0
            for req, s, t in items:
                xp[ofs:ofs + t] = req.x[s:s + t]
                ofs += t
            t0 = time.perf_counter()
            labels = self._program(bucket)(xp)[:total]
        compute_s = time.perf_counter() - t0
        ofs = 0
        for req, s, t in items:
            req.labels[s:s + t] = labels[ofs:ofs + t]
            ofs += t
            req.filled += t
            self._pending_rows -= t
        done = {}
        now = time.perf_counter()
        while self._queue and self._queue[0].filled == self._queue[0].n:
            req = self._queue.popleft()
            done[req.uid] = req.labels
            queue_s = t0 - req.t_submit
            self.rec.series("serve/queue_seconds", queue_s, uid=req.uid)
            self.rec.series("serve/compute_seconds", compute_s, uid=req.uid)
            self.rec.event("serve/request", uid=req.uid, rows=req.n,
                           bucket=bucket, queue_seconds=queue_s,
                           compute_seconds=compute_s,
                           total_seconds=now - req.t_submit)
        self.rec.gauge("serve/queue_rows", self._pending_rows)
        return done

    def drain(self) -> dict[int, np.ndarray]:
        """Tick until the queue is empty; returns every completed request."""
        done = {}
        while self._queue:
            done.update(self.step())
        return done

    def predict(self, x) -> torch.Tensor:
        """Synchronous convenience: submit + drain one request."""
        uid = self.submit(x)
        return torch.from_numpy(self.drain()[uid])
