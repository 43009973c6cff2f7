"""Build and bind the port's CUDA kernels (route (b): nvcc + ctypes).

At first use ``load()`` compiles every ``csrc/*.cu`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` per source, all
started together, links them into ``build/repro_torch/<digest>/libkernels.so``
at the root of the checkout, and loads the library with ``ctypes``. The
digest covers the sources and the flags, so an edited source never loads a
stale library. The C entries take plain pointers and the stream and return
``cudaGetLastError()``; ``launch`` raises when that is not 0.

There is no fallback: a missing ``nvcc``, a failed build or a failed launch
raises. Nothing here runs at import time — the CPU tests import every module
on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
#: C signature of every entry: argtypes (restype is int: the CUDA error)
SIGNATURES = {
    "rt_kernel_matrix_f32": [_P] * 4 + [_I] * 5 + [_F, _F, _I, _P],
    "rt_kernel_matrix_bf16": [_P] * 4 + [_I] * 5 + [_F, _F, _I, _P],
    "rt_kernel_matrix_f32_ctas_per_sm": [_I, _P],
    "rt_kernel_matrix_bf16_ctas_per_sm": [_I, _P],
    "rt_kernel_matrix_col_f32": [_P] * 3 + [_I] * 4 + [_F, _F, _I, _P],
    "rt_kernel_matrix_col_bf16": [_P] * 3 + [_I] * 4 + [_F, _F, _I, _P],
    "rt_assign_fused_f32": [_P] * 9 + [_I] * 6 + [_F, _F, _I, _P],
    "rt_assign_fused_bf16": [_P] * 9 + [_I] * 6 + [_F, _F, _I, _P],
    "rt_assign_f32_ctas_per_sm": [_I, _I, _P],
    "rt_assign_bf16_ctas_per_sm": [_I, _I, _P],
    "rt_embed_assign_f32": [_P] * 8 + [_I] * 5 + [_F, _F, _I, _F, _I, _I,
                                                        _P],
    "rt_embed_assign_bf16": [_P] * 9 + [_I] * 6 + [_F, _F, _I, _F, _P],
    "rt_embed_bf16_ctas_per_sm": [_I, _I, _P],
    "rt_sketch_assign_f32": [_P] * 7 + [_I] * 8 + [_P],
    "rt_sketch_assign_bf16": [_P] * 7 + [_I] * 8 + [_P],
    "rt_flash_attention_f32": [_P] * 4 + [_I] * 7 + [_F, _F]
    + [_L] * 12 + [_P],
    "rt_flash_attention_bf16": [_P] * 4 + [_I] * 7 + [_F, _F]
    + [_L] * 12 + [_P],
}

_LIB: ctypes.CDLL | None = None
#: what the last build did: {"seconds": float, "log": str, "path": str};
#: a cached library brings back the compiler output of its build
LAST_BUILD: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found: repro_torch compiles its CUDA kernels from "
            "src/repro_torch/kernels/csrc at first use on the GPU and needs "
            "the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(SRC_DIR.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of ``libkernels.so``."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    out_dir = BUILD_ROOT / _digest()
    lib, log = out_dir / "libkernels.so", out_dir / "build.log"
    if lib.exists():
        LAST_BUILD.update(seconds=0.0, path=str(lib),
                          log=log.read_text() if log.exists() else "(cached)")
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [s.name for s, p in zip(sources, procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / "libkernels.so"
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"linking libkernels.so failed:\n{link.stdout}")
        text = "\n".join(logs + [link.stdout])
        (Path(tmp) / "build.log").write_text(text)
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(Path(tmp) / "build.log", log)
        os.replace(tmp_lib, lib)   # atomic: a concurrent build loses nothing
    LAST_BUILD.update(seconds=time.perf_counter() - t0, log=text,
                      path=str(lib))
    return lib


def load() -> ctypes.CDLL:
    """Build at first use and return the bound library."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check_operand(t: torch.Tensor, name: str, *, dtype: torch.dtype,
                  shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` is what a kernel takes: on ``device``, of
    ``dtype`` and ``shape``, contiguous and 16-byte aligned."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def launch(entry: str, *args) -> None:
    """Call one C entry on the current stream of the current device and
    raise on a non-zero CUDA error (a refused launch never runs, and a later
    synchronize would not report it). The raw stream handle is read without
    building a ``torch.cuda.Stream`` object, which costs microseconds of
    host time a launch."""
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    err = getattr(load(), entry)(*args, stream)
    if err:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
