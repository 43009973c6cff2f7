"""repro_torch.obs: the flight recorder, the port of ``repro/obs``: runtime
metrics, profiler spans and allocator watermarks of the clustering runtime.

Three rules make it safe to leave on:

  1. Every hook is on the host, around the kernels' launches or on the
     values they return, and outside any CUDA graph capture: recording
     changes no launch, no captured graph and no result (the tests hold
     recorder-on fits bitwise to recorder-off ones, with equal launch
     counts and graph counts).
  2. Tensor values are DEFERRED: ``series`` parks a tensor and
     ``batch_boundary`` reads all of them at the mini-batch edge with one
     device-to-host copy, so a hook adds no host sync inside an inner loop.
  3. The default is ``NullRecorder``: every hook is a no-op, so a run
     without a recorder pays an attribute lookup.

``repro_torch.core.metrics`` scores clustering quality (NMI, accuracy);
this package records where the runtime spends time and bytes.
``export.summarize`` folds a log into per-name aggregates.
"""
from . import export, memory
from .recorder import (NULL, JsonlRecorder, MetricsRecorder, NullRecorder,
                       resolve)
from .trace import batch_spans, span, start_profile, stop_profile

__all__ = [
    "JsonlRecorder", "MetricsRecorder", "NullRecorder", "NULL", "resolve",
    "batch_spans", "span", "start_profile", "stop_profile", "export",
    "memory",
]
