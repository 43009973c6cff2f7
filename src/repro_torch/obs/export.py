"""The run header every JSONL log opens with, readers for the log, and its
fold into per-name aggregates, the port of ``repro/obs/export.py``.

The header pins a run to a code state and a machine (commit, torch
version, backend, device, process count) plus whatever the caller knows
(the ``core.memory.plan``, the entry point), so a log describes itself.

``summarize`` reduces a log to per-name aggregates: count / total / mean /
max of timers, series and gauges, the final totals of counters, and the
last measured-vs-predicted watermark.
"""
from __future__ import annotations

import dataclasses
import json
import os
import platform
import subprocess
import time

import torch


def git_commit() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        return out.stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def run_header(*, device=None, **extra) -> dict:
    """First line of every flight-recorder log. ``device`` names the
    device the run computes on (``None``: the card where one is visible,
    else the CPU); ``extra`` may carry a plan (dataclasses are flattened to
    dicts)."""
    import torch.distributed as dist
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    header = {
        "kind": "header",
        "t": time.time(),
        "commit": git_commit(),
        "torch": torch.__version__,
        "backend": dev.type,
        "device_kind": (torch.cuda.get_device_name(dev) if on_card
                        else platform.processor() or platform.machine()),
        "n_devices": torch.cuda.device_count() if on_card else 1,
        "n_processes": (dist.get_world_size()
                        if dist.is_available() and dist.is_initialized()
                        else 1),
    }
    for k, v in extra.items():
        header[k] = dataclasses.asdict(v) if dataclasses.is_dataclass(v) \
            else v
    return header


def read_events(path: str) -> list[dict]:
    """All records of a JSONL log (header included)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def summarize(path: str) -> dict:
    """Fold a log into per-name aggregates (see the module docstring)."""
    stats: dict[str, dict] = {}
    counters: dict[str, float] = {}
    watermark = None
    n = 0
    for rec in read_events(path):
        n += 1
        kind = rec.get("kind")
        if kind == "counter":
            counters[rec["name"]] = rec.get("total", 0.0)
        elif kind in ("timer", "series", "gauge"):
            v = rec.get("seconds") if kind == "timer" else rec.get("value")
            if v is None:
                continue
            s = stats.setdefault(rec["name"], {"count": 0, "total": 0.0,
                                               "max": float("-inf")})
            s["count"] += 1
            s["total"] += v
            s["max"] = max(s["max"], v)
        elif kind == "event" and rec.get("name") == "hbm_watermark":
            watermark = {k: rec.get(k) for k in
                         ("measured_bytes", "peak_bytes", "predicted_bytes",
                          "source", "batch")}
    for s in stats.values():
        s["mean"] = s["total"] / max(s["count"], 1)
    return {"events": n, "stats": stats, "counters": counters,
            "last_watermark": watermark, "path": path}
