"""Straggler mitigation for the clustering runtime, the port of
``repro/ft/straggler.py``.

Between mini-batches the only live state is O(C*d) (medoids + cardinalities),
so re-partitioning work is nearly free. The planner assigns each worker a row
range proportional to its measured throughput; dead workers get nothing and
their rows are redistributed (the paper's row-wise layout makes this a pure
index calculation — no data migration of K, which is recomputed per batch
anyway).

``StragglerMonitor`` is the live wiring: the distributed outer loop feeds
it per-worker mini-batch timings after every batch, it keeps a rolling
throughput estimate per worker, and when one worker falls past the median
threshold it emits a ``straggler_detected`` event through the flight
recorder (``repro_torch.obs``) carrying the per-worker timings and the
row replan that would absorb the skew. The port's mesh runs one process a
device, so its timing unit is the *rank*: every rank feeds its own
monitor its own batch time (no collective is spent on timings).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class WorkerStatus:
    worker_id: int
    healthy: bool = True
    rows_per_second: float = 1.0   # measured on the previous mini-batch


def replan_rows(n_rows: int, statuses: list[WorkerStatus], *,
                quantum: int = 8) -> dict[int, tuple[int, int]]:
    """-> {worker_id: (row_start, n_rows)}; proportional to throughput,
    quantized to ``quantum`` rows (tile alignment), exact cover of n_rows."""
    alive = [s for s in statuses if s.healthy]
    if not alive:
        raise RuntimeError("no healthy workers")
    speed = np.array([max(s.rows_per_second, 1e-9) for s in alive])
    frac = speed / speed.sum()
    sizes = np.floor(frac * n_rows / quantum).astype(int) * quantum
    # distribute the remainder to the fastest workers, quantum at a time
    rem = n_rows - sizes.sum()
    order = np.argsort(-speed)
    i = 0
    while rem >= quantum:
        sizes[order[i % len(alive)]] += quantum
        rem -= quantum
        i += 1
    if rem:
        sizes[order[0]] += rem
    plan = {}
    start = 0
    for s, sz in zip(alive, sizes):
        plan[s.worker_id] = (start, int(sz))
        start += int(sz)
    assert start == n_rows
    return plan


def detect_stragglers(batch_seconds: dict[int, float], *,
                      threshold: float = 1.5) -> list[int]:
    """Workers slower than ``threshold`` x median are flagged."""
    if not batch_seconds:
        return []
    med = float(np.median(list(batch_seconds.values())))
    return [w for w, t in batch_seconds.items() if t > threshold * med]


class StragglerMonitor:
    """Per-batch straggler watch, reporting through the flight recorder.

    ``observe(batch, timings, n_rows)`` takes this batch's per-worker wall
    seconds; every call records a ``batch_timing`` event and updates the
    rolling ``WorkerStatus`` throughputs (EWMA over ``decay``). When
    ``detect_stragglers`` flags anyone, a ``straggler_detected`` event is
    emitted with the timings and — when ``n_rows`` is known — the
    ``replan_rows`` partition that would rebalance the next batch. Returns
    the flagged worker ids so a caller can act on them.
    """

    def __init__(self, recorder=None, *, threshold: float = 1.5,
                 decay: float = 0.5, quantum: int = 8):
        from repro_torch.obs import resolve
        self.rec = resolve(recorder)
        self.threshold = threshold
        self.decay = decay
        self.quantum = quantum
        self.statuses: dict[object, WorkerStatus] = {}

    def observe(self, batch: int, timings: dict[object, float],
                n_rows: int | None = None) -> list:
        if not timings:
            return []
        rows_each = (n_rows / max(len(timings), 1)) if n_rows else None
        for w, dt in timings.items():
            rps = (rows_each / max(dt, 1e-9)) if rows_each else \
                1.0 / max(dt, 1e-9)
            st = self.statuses.get(w)
            if st is None:
                self.statuses[w] = WorkerStatus(worker_id=w,
                                                rows_per_second=rps)
            else:
                st.rows_per_second = (self.decay * rps
                                      + (1.0 - self.decay)
                                      * st.rows_per_second)
        self.rec.event("batch_timing", batch=int(batch),
                       timings={str(k): v for k, v in timings.items()})
        slow = detect_stragglers(timings, threshold=self.threshold)
        if slow:
            replan = None
            if n_rows and len(self.statuses) > 1:
                plan = replan_rows(
                    int(n_rows - n_rows % self.quantum) or self.quantum,
                    list(self.statuses.values()), quantum=self.quantum)
                replan = {str(k): v for k, v in plan.items()}
            self.rec.event(
                "straggler_detected", batch=int(batch),
                stragglers=[str(w) for w in slow],
                timings={str(k): v for k, v in timings.items()},
                replan=replan)
        return slow
