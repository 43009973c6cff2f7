"""Profiler spans over the program's layers and on-demand traces, the
port of ``repro/obs/trace.py``.

  ``span(name)``  -> ``torch.profiler.record_function`` while a profiler
                     runs: names the host region and the kernels launched
                     inside it in the trace. With no profiler running it is
                     a shared null context: a ``record_function`` costs
                     about 9 us of host time a call even then
                     (``chip_smoke.py`` phase 4e, H100 host), where the
                     reference's ``jax.named_scope`` cost nothing at run
                     time; the check costs a fraction of a microsecond. A
                     span adds no launch, no host read and no allocation,
                     so a fit traced or not gives the same result.
  ``batch_spans`` -> the outer loops' batches, each in its ``obs:batch``.

The spans of a fit, each inside its parent on the calling thread:

  ``obs:fit``                  one fit (``core.minibatch.fit`` /
                               ``fit_dataset``, ``distributed.outer``)
    ``obs:batch``              one pass of the outer loop
      ``obs:stage``            fetching the batch and putting it on the
                               device
      ``obs:embed_phi``        an embedded fit's map of the batch (the
                               map's draw: under ``obs:fit``)
      ``obs:landmarks``        the landmark draw
      ``obs:kmeanspp``         the k-means++ seeds (first batch)
      ``obs:eq8``              the initial labels (Eq.8, or the embedded
                               warm start)
      ``obs:gram_panel_build`` a materialized Gram block
      ``obs:sweep``            one inner-loop iteration
        ``obs:engine_stats[<mode>]``, ``obs:allgather_u``,
        ``obs:psum_fused``     its stats and the mesh's collectives
          ``obs:g_from_rows``  g's K_ll @ H taken from f's landmark
                               rows (``core/engine.py``)
      ``obs:merge``            the Eq.7 medoids and the Eq.12 merge (the
                               embedded centroid merge)
  ``obs:predict``              ``FitResult.predict``

and ``obs:host_read[<site>]`` around each read of a device value by the
host, one read a span, named by its site: ``changed`` (a sweep's flag),
``batch_stats`` (a batch's ``BatchStats``), ``merge_rows`` (the mesh's
medoid row indices), ``kmeanspp`` (a seeding step's pick). Their count in a
window is the count of host reads.

``start_profile(logdir)`` / ``stop_profile()`` run a
``torch.profiler.profile`` over CPU activity and, where a card is visible,
CUDA activity (CUPTI), and write a Chrome trace ``trace.json`` into
``logdir`` (``chrome://tracing`` or ``https://ui.perfetto.dev`` opens it).
The launchers expose this as ``--profile DIR``.
"""
from __future__ import annotations

import contextlib
import itertools
import os
from typing import Iterable, Iterator

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A named region of the program (see the module docstring)."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


_END = object()


def batch_spans(batches: Iterable, start: int = 0) -> Iterator:
    """``(i, batch)`` for each batch of ``batches``, numbered from
    ``start``, with its ``obs:batch`` span open while the caller works on
    it. Batch i + 1 is fetched, under ``obs:stage``, at the end of batch
    i's span (batch 0 at the start of its own), so every fetch lies in a
    batch and the span count is the batch count; the order of the work is
    a plain ``for`` loop's."""
    it = iter(batches)
    for i in itertools.count(start):
        with span("obs:batch"):
            if i == start:
                with span("obs:stage"):
                    xb = next(it, _END)
                if xb is _END:
                    return
            yield i, xb
            with span("obs:stage"):
                xb = next(it, _END)
        if xb is _END:
            return


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
