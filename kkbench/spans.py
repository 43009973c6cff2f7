"""The program's spans in a traced window, reduced per span name.

A span is a host op of ``kkbench/trace.py``'s ``Trace`` named ``obs:...``
(``repro_torch.obs.span``, a ``record_function`` while the profiler runs)
on the window's thread (``Trace.tid``). Spans on one thread nest. Per
name, ``reduce`` gives:

- ``count``: the spans that start inside the window;
- ``self_s``: host time in which a span of the name is the innermost one
  open, that is its duration less the part its child spans cover;
- ``device_s``: the device time of the kernels, copies and sets launched
  on the window's thread while a span of the name was open (as
  ``Trace.kernels_under`` counts them, children's launches included);
- ``idle_s``: the device's idle time charged to the name: each idle
  instant of the window goes to the innermost span open at that instant,
  or to ``NONE`` where none is;
- ``idle_in_s``: idle time in which a span of the name was open at any
  depth (its own ``idle_s`` and its descendants').

Host spans and device ops come from one trace, so they share the
profiler's clock; no other clock is read."""
from __future__ import annotations

import bisect
import dataclasses
import weakref

PREFIX = "obs:"
HOST_READ = "obs:host_read["
NONE = "(none)"


@dataclasses.dataclass
class Row:
    count: int = 0
    self_s: float = 0.0
    device_s: float = 0.0
    idle_s: float = 0.0
    idle_in_s: float = 0.0


_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def reduce(trace) -> dict:
    """{span name or ``NONE``: ``Row``} of ``trace``'s window (computed
    once a trace)."""
    got = _CACHE.get(trace)
    if got is None:
        got = _CACHE[trace] = _reduce(trace)
    return got


def _reduce(trace) -> dict:
    t0, t1 = trace.t0, trace.t1
    sp = sorted(((n, a, b) for n, a, b, tid in trace.host
                 if tid == trace.tid and tid is not None
                 and n.startswith(PREFIX) and b > t0 and a < t1),
                key=lambda s: (s[1], -s[2]))
    rows: dict = {}

    def row(name):
        r = rows.get(name)
        if r is None:
            r = rows[name] = Row()
        return r

    # the window cut into segments, each with its innermost open span (an
    # index into ``sp``, -1 for none); ``parent`` links each span to the
    # one it nests in
    parent, segs, stack = [], [], []
    cur = t0

    def emit(a, b, k):
        a, b = max(a, t0), min(b, t1)
        if b > a:
            segs.append((a, b, k))

    for k, (name, a, b) in enumerate(sp):
        if t0 <= a <= t1:
            row(name).count += 1
        while stack and sp[stack[-1]][2] <= a:
            j = stack.pop()
            emit(cur, sp[j][2], j)
            cur = max(cur, sp[j][2])
        emit(cur, a, stack[-1] if stack else -1)
        cur = max(cur, a)
        parent.append(stack[-1] if stack else -1)
        stack.append(k)
    while stack:
        j = stack.pop()
        emit(cur, sp[j][2], j)
        cur = max(cur, sp[j][2])
    emit(cur, t1, -1)

    def names(k):
        """The distinct names open at a segment of span ``k``, innermost
        first."""
        out = []
        while k >= 0:
            if sp[k][0] not in out:
                out.append(sp[k][0])
            k = parent[k]
        return out or [NONE]

    for a, b, k in segs:
        row(sp[k][0] if k >= 0 else NONE).self_s += (b - a) * 1e-6

    # idle: the window less the device's busy intervals, laid over the
    # segments
    idle, last = [], t0
    for a, b in trace.busy_intervals():
        if a > last:
            idle.append((last, a))
        last = max(last, b)
    if t1 > last:
        idle.append((last, t1))
    i = j = 0
    while i < len(segs) and j < len(idle):
        a = max(segs[i][0], idle[j][0])
        b = min(segs[i][1], idle[j][1])
        if b > a:
            dt = (b - a) * 1e-6
            open_names = names(segs[i][2])
            row(open_names[0]).idle_s += dt
            for n in open_names:
                row(n).idle_in_s += dt
        if segs[i][1] <= idle[j][1]:
            i += 1
        else:
            j += 1

    # device time by the span open at each op's launch
    starts = [s[0] for s in segs]
    for _, _, dur, corr in trace.kernels(lambda name: True):
        got = trace.launch.get(corr)
        if got is None or got[1] != trace.tid:
            continue
        s = bisect.bisect_right(starts, got[0]) - 1
        k = segs[s][2] if s >= 0 and got[0] <= segs[s][1] else -1
        for n in names(k):
            row(n).device_s += dur * 1e-6
    return rows


def idle_share(trace, name: str):
    """The share of the window, in %, in which the device sat idle while a
    ``name`` span was open; None without device ops or such spans."""
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    r = reduce(trace).get(name)
    if r is None or not r.count:
        return None
    return 100.0 * r.idle_in_s / trace.window_s
