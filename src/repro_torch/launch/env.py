"""Process-level environment for the launchers, the port's counterpart of
``repro/launch/env.py``.

The reference stages XLA flags (the latency-hiding scheduler, async
collectives, the collective stream's priority) before the first jax
import, because XLA reads them once at backend init. The port's
counterparts are NCCL and CUDA variables, read once when the CUDA context
is created and when a NCCL process group starts:

* ``configure(...)``: call it FIRST in a launcher's ``main``, before
  anything touches the card or starts a process group. It merges
  ``PROCESS_VARIABLES`` into ``os.environ`` without overwriting a
  variable the caller (or ``torchrun``, or a test harness) already set,
  and warns when the CUDA context or the process group already exists,
  since then nothing it sets takes effect in this process.
* ``device_from_argv(...)``: the counterpart of ``platform_from_argv``;
  pre-parses ``--device`` from the raw argv.
* ``set_device(...)``: the counterpart of ``set_platform``: the
  launcher's device, ``cuda:LOCAL_RANK`` under ``torchrun``, made current.

The one variable set here decides what a failed collective does; none
changes a number the program computes, nor the caching allocator that
PERF.md's watermarks measured (``PYTORCH_CUDA_ALLOC_CONF`` is left
alone). The reference's scheduling flags (the latency-hiding scheduler,
the collective stream's priority) have NCCL and CUDA counterparts
(``CUDA_DEVICE_MAX_CONNECTIONS``, ``TORCH_NCCL_HIGH_PRIORITY``), which
are not set: no measurement of the port shows what they change, and a
world of one has no collective for compute to overlap.
"""
from __future__ import annotations

import os
import sys
import warnings

import torch

#: (variable, value, what it stands for)
PROCESS_VARIABLES = (
    # a failed or timed-out collective tears the process down instead of
    # leaving the other ranks hanging. XLA: no flag; its runtime aborts on
    # a NCCL error by itself
    ("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1"),
)


def device_from_argv(argv=None) -> str | None:
    """``--device <d>`` / ``--device=<d>`` from the raw argv (default:
    ``sys.argv``), or None when absent."""
    argv = sys.argv[1:] if argv is None else list(argv)
    for i, tok in enumerate(argv):
        if tok == "--device" and i + 1 < len(argv):
            return argv[i + 1]
        if tok.startswith("--device="):
            return tok.split("=", 1)[1]
    return None


def configure() -> dict:
    """Merge ``PROCESS_VARIABLES`` into the environment; a variable that
    is already set keeps its value. Idempotent. Returns what was applied
    (for the recorder's run header)."""
    applied: dict = {}
    changed = False
    for name, value in PROCESS_VARIABLES:
        if name not in os.environ:
            os.environ[name] = value
            changed = True
        applied[name] = os.environ[name]
    if changed and (torch.cuda.is_initialized()
                    or (torch.distributed.is_available()
                        and torch.distributed.is_initialized())):
        warnings.warn(
            "repro_torch.launch.env.configure() set process variables after "
            "the CUDA context or the process group was created; they will "
            "not take effect in this process", RuntimeWarning, stacklevel=2)
    return applied


def set_device(device=None) -> torch.device:
    """The launcher's device: ``device`` if given, ``cuda:LOCAL_RANK``
    under torchrun, else the card (raising without one, as
    ``repro_torch.device`` does); a CUDA device is made current."""
    from repro_torch.device import resolve_device
    if device is None and "LOCAL_RANK" in os.environ:
        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    return dev
