"""Profiler spans over the named hot paths and on-demand traces, the port of
``repro/obs/trace.py``.

  ``span(name)``      -> ``torch.profiler.record_function`` while a
                         profiler runs: names the host region and the
                         kernels launched inside it in the trace (the Gram
                         panel build, the engine stats, the mesh's
                         collectives). With no profiler running it is a
                         shared null context: a ``record_function`` costs
                         about 9 us of host time a call even then
                         (``chip_smoke.py`` phase 4e, H100 host), where the
                         reference's ``jax.named_scope`` cost nothing at
                         run time; the check costs a fraction of a
                         microsecond.
  ``annotate(name)``  -> the same, for host activity (loader staging, the
                         embedding of a mesh shard). Keyword arguments are
                         accepted and ignored.

``start_profile(logdir)`` / ``stop_profile()`` run a
``torch.profiler.profile`` over CPU activity and, where a card is visible,
CUDA activity (CUPTI), and write a Chrome trace ``trace.json`` into
``logdir`` (``chrome://tracing`` or ``https://ui.perfetto.dev`` opens it).
The launchers expose this as ``--profile DIR``.
"""
from __future__ import annotations

import contextlib
import os

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """Named region for device work (see the module docstring)."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def annotate(name: str, **kwargs):
    """Named region for host activity; ``kwargs`` are ignored."""
    return span(name)


_active: tuple | None = None        # (logdir, profiler) of the capture


def start_profile(logdir: str) -> None:
    """Begin a profiler capture for ``logdir`` (idempotent: starting while
    one is active keeps the first). Raises when the profiler cannot
    start (e.g. no CUPTI for the card's activity)."""
    global _active
    if _active is not None:
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    try:
        prof.start()
    except Exception as e:
        raise RuntimeError(f"the profiler could not start over {acts}: "
                           f"{e!r}") from e
    _active = (logdir, prof)


def stop_profile() -> str | None:
    """Stop the capture and write ``<logdir>/trace.json``; returns the
    logdir (None when no capture was active)."""
    global _active
    if _active is None:
        return None
    (logdir, prof), _active = _active, None
    prof.stop()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    return logdir
