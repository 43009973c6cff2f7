"""Checkpoints as numpy files with an atomic manifest, the port of
``repro/ft/checkpoint.py``, on the reference's on-disk layout, so either
package reads the other's checkpoints:

    <root>/step_000000042.tmp/       # written first
        manifest.json                # {"step", "extra", "leaves": {path:
                                     #  {"file", "shape", "dtype"}}}
        <leafpath>.npy               # one file per leaf
    <root>/step_000000042/           # atomic os.rename on completion

A tree is a nest of NamedTuples (leaf path ``.field``), dicts (``key``),
lists and tuples (``[i]``) and the feature maps (``0`` and ``1``: RFF's w
and b, Nystrom's landmarks and projection, a sketch's hash and signs),
with tensors, numpy arrays and Python numbers as leaves: the paths the
reference's pytrees flatten to (``GlobalState`` -> ``.medoids``, ...; a
fit with its map -> ``state/.centroids``, ``fmap/0``, ...). A state is
loaded into the structure of a ``like`` tree on the device asked for; it
does not depend on the mesh, so a restart may run on another world size.
A partly written checkpoint (a crash mid-save) stays invisible: the .tmp
directory is never listed and is cleaned by the next save.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any, Optional

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d{9})$")

#: the children of the feature maps, in the reference's pytree order
_MAP_FIELDS = {"RFFMap": ("w", "b"), "NystromMap": ("landmarks", "proj"),
               "CountSketchMap": ("h", "sign"),
               "TensorSketchMap": ("hs", "signs")}


def _children(node):
    """[(path key, child)] of an inner node, or None for a leaf."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    fields = _MAP_FIELDS.get(type(node).__name__)
    if fields is not None and dataclasses.is_dataclass(node):
        return [(str(i), getattr(node, f)) for i, f in enumerate(fields)]
    return None


def _leaves(tree, prefix=()) -> list[tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [("/".join(prefix), tree)]
    out = []
    for k, v in kids:
        out += _leaves(v, prefix + (k,))
    return out


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:   # as the reference: raw 2 bytes
            return leaf.view(torch.int16).numpy().view(np.dtype("V2"))
        return leaf.numpy()
    if isinstance(leaf, bool):
        return np.asarray(leaf)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float32)
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, dtype: str, like, device):
    """A loaded array in the type of ``like``: a Python number, a numpy
    array, else a tensor on ``device``."""
    if isinstance(like, (bool, int, float)) and not torch.is_tensor(like):
        return type(like)(arr.item())
    if isinstance(like, np.ndarray):
        return arr
    # ascontiguousarray makes a 0-d array 1-d: keep the saved shape
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _rebuild(like, values, prefix=()):
    """``like`` with its leaves replaced from ``values`` {path: value}."""
    kids = _children(like)
    if kids is None:
        return values["/".join(prefix)]
    new = [_rebuild(v, values, prefix + (k,)) for k, v in kids]
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*new)
    if isinstance(like, dict):
        return dict(zip(sorted(like), new))
    if isinstance(like, (list, tuple)):
        return type(like)(new)
    fields = _MAP_FIELDS[type(like).__name__]
    return dataclasses.replace(like, **dict(zip(fields, new)))


class CheckpointManager:
    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    # -- write --------------------------------------------------------------

    def save(self, step: int, tree, *, extra: dict | None = None) -> None:
        final = os.path.join(self.root, f"step_{step:09d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        for name, leaf in _leaves(tree):
            arr = _to_numpy(leaf)
            dtype = ("bfloat16" if torch.is_tensor(leaf)
                     and leaf.dtype == torch.bfloat16 else str(arr.dtype))
            fname = name.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][name] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                       # atomic commit
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- read ---------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.root):
            m = _STEP_RE.match(d)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _manifest(self, step: int) -> dict:
        with open(os.path.join(self.root, f"step_{step:09d}",
                               "manifest.json")) as f:
            return json.load(f)

    def restore(self, step: int, like, *, device="cpu"):
        """Load step ``step`` into the structure of ``like`` (its leaves
        only name their type; shapes come from the files), tensors on
        ``device``."""
        d = os.path.join(self.root, f"step_{step:09d}")
        meta = self._manifest(step)["leaves"]
        values = {}
        for name, leaf in _leaves(like):
            m = meta[name]
            arr = np.load(os.path.join(d, m["file"]))
            values[name] = _from_numpy(arr, m["dtype"], leaf, device)
        return _rebuild(like, values)

    def extra(self, step: int) -> dict:
        return self._manifest(step)["extra"]
