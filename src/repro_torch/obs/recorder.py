"""MetricsRecorder contract and its two implementations, the port of
``repro/obs/recorder.py``.

``MetricsRecorder`` defines the vocabulary every instrumented layer speaks:

  counter(name, inc)      monotonically accumulating count (collectives
                          run, batches staged, requests submitted)
  gauge(name, value)      instantaneous host scalar (queue depth, empty
                          clusters), recorded at once
  series(name, value)     per-iteration measurement; ``value`` MAY be a
                          ``torch.Tensor`` on the CPU or the card: it is
                          parked unconverted and drained at
                          ``batch_boundary`` (never a blocking read mid-loop)
  timer(name)             context manager measuring host wall seconds
  event(name, **fields)   structured one-off (straggler_detected, resume,
                          hbm_watermark)
  batch_boundary(batch)   drain the parked tensors and flush the sink

``NullRecorder`` (singleton ``NULL``) is the default: every hook is a
no-op, ``timer`` returns a shared null context manager, no state is kept.
``JsonlRecorder`` appends one JSON object per record to a file. It is
thread-safe (a ``PrefetchLoader`` producer thread records stage times
while the consumer loop records and drains) and buffers lines on the host,
flushing only at batch boundaries and on ``close``.

The drain moves every parked tensor of one device to the host at once:
each is cast to float64 on its own device, they are stacked, and one
``.tolist()`` reads the stack, so a batch boundary costs one device-to-host
copy for the card's values (on the current stream, after the loop's last
use of them) and none for the CPU's. No hook calls ``.item()`` per value.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import torch


class _NullTimer:
    """Shared no-op context manager (``NullRecorder.timer``)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_TIMER = _NullTimer()


class MetricsRecorder:
    """The contract, and the no-op base (see the module docstring)."""

    enabled: bool = False

    def counter(self, name: str, inc: float = 1, **tags) -> None:
        pass

    def gauge(self, name: str, value, **tags) -> None:
        pass

    def series(self, name: str, value, **tags) -> None:
        pass

    def event(self, name: str, **fields) -> None:
        pass

    def timer(self, name: str, **tags):
        return _NULL_TIMER

    def batch_boundary(self, batch: int) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "MetricsRecorder":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class NullRecorder(MetricsRecorder):
    """The default; every hook is a no-op."""


NULL = NullRecorder()


def resolve(recorder: Optional[MetricsRecorder]) -> MetricsRecorder:
    """``recorder=None`` anywhere means ``NULL``."""
    return NULL if recorder is None else recorder


class _Timer:
    __slots__ = ("_rec", "_name", "_tags", "_t0", "seconds")

    def __init__(self, rec: "JsonlRecorder", name: str, tags: dict):
        self._rec = rec
        self._name = name
        self._tags = tags

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        self._rec._append(dict(kind="timer", name=self._name,
                               seconds=self.seconds, **self._tags))
        return False


def _drain(values: list) -> list[float]:
    """Scalar tensors -> Python floats: one float64 stack and one
    ``.tolist()`` per device, whatever their dtypes."""
    out: list = [None] * len(values)
    by_device: dict = {}
    for k, v in enumerate(values):
        by_device.setdefault(v.device, []).append(k)
    for idx in by_device.values():
        stack = torch.stack([values[k].detach().to(torch.float64).reshape(())
                             for k in idx])
        for k, v in zip(idx, stack.tolist()):
            out[k] = v
    return out


class JsonlRecorder(MetricsRecorder):
    """Flight recorder writing one JSON object per line.

    ``header`` (``repro_torch.obs.export.run_header``) is the first line,
    so a log describes itself: commit, backend, devices, plan. Counter
    increments are written as they happen and summed per name into
    ``totals``. ``series`` tensors wait in ``_pending`` until
    ``batch_boundary`` drains them (the only place this class reads a
    tensor)."""

    enabled = True

    def __init__(self, path: str, *, header: Optional[dict] = None):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._lines: list[dict] = []
        self._pending: list[dict] = []      # series holding a tensor
        self.totals: dict[str, float] = {}
        self._file = open(path, "w")
        if header is not None:
            self._append(header)
            self._flush()

    # -- record vocabulary --------------------------------------------------

    def counter(self, name: str, inc: float = 1, **tags) -> None:
        with self._lock:
            self.totals[name] = total = self.totals.get(name, 0.0) + inc
        self._append(dict(kind="counter", name=name, inc=inc, total=total,
                          **tags))

    def gauge(self, name: str, value, **tags) -> None:
        self._append(dict(kind="gauge", name=name, value=float(value),
                          **tags))

    def series(self, name: str, value, **tags) -> None:
        # a tensor waits for the boundary; plain numbers are written now
        if torch.is_tensor(value):
            with self._lock:
                self._pending.append(dict(kind="series", name=name,
                                          value=value, t=time.time(),
                                          **tags))
            return
        self._append(dict(kind="series", name=name, value=float(value),
                          **tags))

    def event(self, name: str, **fields) -> None:
        self._append(dict(kind="event", name=name, **fields))

    def timer(self, name: str, **tags):
        return _Timer(self, name, tags)

    def batch_boundary(self, batch: int) -> None:
        """Drain the parked tensors (one read per device) and flush."""
        with self._lock:
            pending, self._pending = self._pending, []
        if pending:
            for p, v in zip(pending, _drain([p["value"] for p in pending])):
                p["value"] = v
                self._append(p)
        self._append(dict(kind="boundary", batch=int(batch)))
        self._flush()

    # -- sink ---------------------------------------------------------------

    def _append(self, rec: dict) -> None:
        rec.setdefault("t", time.time())
        with self._lock:
            self._lines.append(rec)

    def _flush(self) -> None:
        with self._lock:
            lines, self._lines = self._lines, []
            if lines and self._file is not None:
                self._file.write("".join(
                    json.dumps(r, default=_jsonable) + "\n" for r in lines))
                self._file.flush()

    def close(self) -> None:
        if self._file is None:
            return
        self.batch_boundary(-1)     # the final drain marks the run's end
        with self._lock:
            self._file.close()
            self._file = None


def _jsonable(v):
    """``json.dumps`` fallback: tensors, numpy scalars and arrays ->
    Python values."""
    try:
        if torch.is_tensor(v):
            return v.detach().cpu().tolist()
        import numpy as np
        a = np.asarray(v)
        return a.item() if a.ndim == 0 else a.tolist()
    except Exception:
        return str(v)
