"""Allocator watermarks recorded next to the planner's predicted footprint,
the port of ``repro/obs/memory.py``.

``core.memory.plan`` prices every Gram residency and embedding method from
a static byte model. ``watermark`` samples the caching allocator of the
device a fit runs on (``torch.cuda.memory_stats``: bytes allocated now and
their peak) at a mini-batch boundary and records it in the SAME event as
the predicted per-device bytes of that batch and mode, so one
``hbm_watermark`` line a batch is the measured-vs-predicted pair. The peak
is the process's since its start (or since a caller reset it); this module
resets nothing, as the reference resets nothing.

On the CPU there are no allocator stats: the fallback is the host's peak
RSS (``resource.getrusage``), tagged ``source: "host_rss"`` so a reader
never takes process memory for device memory.

``predicted_batch_footprint`` re-prices one mini-batch with the
``core.memory`` formulas at (n = batch rows, B = 1): the per-device bytes
the planner claims for the exact engine mode or embedded method the fit
runs.
"""
from __future__ import annotations

from typing import Optional

import torch

from .recorder import MetricsRecorder


def device_memory_stats(device=None) -> list[dict]:
    """``[{"device", "bytes_in_use", "peak_bytes_in_use"}]`` of ``device``
    (a card), or of the current card where ``device`` is None and this
    process has used one; empty for the CPU."""
    if device is None:
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return []
        device = torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type != "cuda":
        return []
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    stats = torch.cuda.memory_stats(dev)
    now = int(stats.get("allocated_bytes.all.current", 0))
    return [{"device": f"cuda:{dev.index}", "bytes_in_use": now,
             "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                                now))}]


def host_rss_peak_bytes() -> Optional[int]:
    """Peak resident set size of this process (the CPU fallback)."""
    try:
        import resource
        import sys
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # ru_maxrss is KiB on Linux, bytes on macOS
        return int(peak if sys.platform == "darwin" else peak * 1024)
    except Exception:
        return None


def watermark(recorder: MetricsRecorder, *, batch: int,
              predicted_bytes: Optional[float] = None, device=None,
              **tags) -> None:
    """Record one ``hbm_watermark`` event: the allocator's bytes on
    ``device`` (the fit's) next to the planner's predicted per-device
    bytes."""
    if not recorder.enabled:
        return                       # no stats calls at all
    devs = device_memory_stats(device)
    if devs:
        measured = max(d["bytes_in_use"] for d in devs)
        peak = max(d["peak_bytes_in_use"] for d in devs)
        source = "device"
    else:
        measured = peak = host_rss_peak_bytes()
        source = "host_rss"
    recorder.event(
        "hbm_watermark", batch=int(batch), source=source,
        measured_bytes=measured, peak_bytes=peak,
        predicted_bytes=(float(predicted_bytes)
                         if predicted_bytes is not None else None),
        devices=devs, **tags)


def predicted_batch_footprint(cfg, n_rows: int, d: int, *,
                              n_devices: int = 1,
                              density: float = 1.0) -> float:
    """Planner-predicted per-device bytes of ONE mini-batch of ``n_rows``
    rows under ``cfg`` (a ``MiniBatchConfig``): ``engine_footprint_bytes``
    at the fit's GramEngine mode for the exact method,
    ``embed_footprint_bytes`` / ``sketch_footprint_bytes`` at the fit's m
    for the embedded ones."""
    from repro_torch.core import memory as cm

    c = cfg.n_clusters
    if cfg.method == "exact":
        from repro_torch.core.engine import resolve_engine
        eng = resolve_engine(cfg.engine)
        return cm.engine_footprint_bytes(
            n_rows, 1, c, n_devices, s=cfg.s, d=d,
            mode=eng.mode, tile_rows=eng.tile_rows)
    m = cfg.embed_dim
    if not m:
        from repro_torch.approx import default_embed_dim
        m = default_embed_dim(c)
    if cfg.method in ("sketch", "tensorsketch"):
        return cm.sketch_footprint_bytes(n_rows, 1, c, n_devices, m=m, d=d,
                                         density=density)
    return cm.embed_footprint_bytes(n_rows, 1, c, n_devices, m=m, d=d)


def predicted_embed_footprint(n_rows: int, c: int, fmap, *,
                              sparse: bool = False, density: float = 1.0,
                              n_devices: int = 1) -> Optional[float]:
    """Predicted per-device bytes of one embedded-space batch, priced from
    the live feature map (m = ``fmap.dim``, d = ``fmap.in_dim``); a sparse
    batch takes the O(nnz) sketch pricing at its density."""
    from repro_torch.core import memory as cm

    m = getattr(fmap, "dim", 0)
    d = getattr(fmap, "in_dim", 0)
    if not m:
        return None
    if sparse:
        return cm.sketch_footprint_bytes(n_rows, 1, c, n_devices, m=m, d=d,
                                         density=density)
    return cm.embed_footprint_bytes(n_rows, 1, c, n_devices, m=m, d=d)
