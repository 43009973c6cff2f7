"""The traced window: ``torch.profiler`` over CPU and CUDA, exported as a
Chrome trace to a temporary file (deleted once read) and reduced here to
device intervals, kernels by name, the host spans that launched them, and
the idle gaps with what the host was doing in each."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "kkbench:window"


def capture(fn):
    """Run ``fn`` under the profiler -> (its result, ``Trace``)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return out, Trace(data.get("traceEvents", data))


class Trace:
    def __init__(self, events):
        self.device, self.launch, self.host = [], {}, []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((e.get("name", ""), ts, dur, corr))
            elif cat in LAUNCH_CATS and corr is not None:
                self.launch[corr] = (ts, e.get("tid"))
            elif cat in HOST_CATS:
                self.host.append((e.get("name", ""), ts, ts + dur,
                                  e.get("tid")))
        self.device.sort(key=lambda k: k[1])
        win = [h for h in self.host if h[0] == WINDOW]
        if win:
            self.t0, self.t1, self.tid = win[0][1], win[0][2], win[0][3]
        else:
            self.t0 = min((k[1] for k in self.device), default=0.0)
            self.t1 = max((k[1] + k[2] for k in self.device), default=0.0)
            self.tid = None

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self, match=None):
        """Union of the intervals of device ops inside the window (those
        whose name ``match`` accepts, where given), in us."""
        out = []
        for name, ts, dur, _ in self.device:
            if match is not None and not match(name):
                continue
            a, b = max(ts, self.t0), min(ts + dur, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernels(self, match) -> list:
        """Device ops inside the window whose name ``match`` accepts:
        [(name, ts, dur, corr)]."""
        return [k for k in self.device
                if self.t0 <= k[1] <= self.t1 and match(k[0])]

    def kernels_under(self, span: str, match=lambda name: True) -> list:
        """Device ops launched while a host span named ``span`` was open on
        the launching thread."""
        spans = defaultdict(list)
        for name, a, b, tid in self.host:
            if name == span:
                spans[tid].append((a, b))
        for v in spans.values():
            v.sort()
        starts = {tid: [a for a, _ in v] for tid, v in spans.items()}
        out = []
        for k in self.kernels(match):
            got = self.launch.get(k[3])
            if got is None or got[1] not in spans:
                continue
            ts, tid = got
            j = bisect.bisect_right(starts[tid], ts) - 1
            # spans of one name do not nest: the latest start is the one
            if j >= 0 and spans[tid][j][1] >= ts:
                out.append(k)
        return out

    def count(self, span: str) -> int:
        return sum(1 for h in self.host
                   if h[0] == span and self.t0 <= h[1] <= self.t1)

    def device_ops(self, top: int = 10) -> list:
        tot = defaultdict(float)
        for name, ts, dur, _ in self.kernels(lambda n: True):
            tot[name] += dur * 1e-6
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda r: -r[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle time of the device inside the window, summed by the
        innermost host op open on the window's thread when each gap
        began."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        host = sorted((h for h in self.host
                       if h[3] == self.tid and h[0] != WINDOW),
                      key=lambda h: (h[1], -h[2]))
        tot = defaultdict(float)
        stack, j = [], 0          # the ops open at the sweep's time
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            while j < len(host) and host[j][1] <= a:
                while stack and stack[-1][2] < host[j][1]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1][2] < a:
                stack.pop()
            name = stack[-1][0] if stack else "(no host op)"
            tot[name] += (b - a) * 1e-6
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda r: -r[1])[:top]
