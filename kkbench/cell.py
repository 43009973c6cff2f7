"""Cells as data: ``BENCHMARK.json`` names them, ``workloads/<cell>.json``
holds a cell (its configuration, entry, method, batches and world size,
its data seed and cycle of fit seeds, and the limits of its comparison),
``configs/<config>.json`` its configuration. A cell's settings are its configuration's with the
workload's keys over them."""
from __future__ import annotations

import json
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load(name: str) -> dict:
    """The settings of cell ``name``."""
    wl = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    cfg = json.loads((HERE / "configs" / f"{wl['config']}.json").read_text())
    return {**cfg, **wl, "name": name}


def gamma(cell: dict, x: torch.Tensor) -> float:
    """The configuration's kernel width: the paper's sigma = factor * d_max
    rule (§4.4) on the first ``gamma_rows`` rows, d_max the diagonal of
    their bounding box in float32, gamma = 1 / (2 sigma^2)."""
    k = cell["kernel"]
    rows = x[:k["gamma_rows"]]
    span = torch.amax(rows, dim=0) - torch.amin(rows, dim=0)
    d_max = float(torch.sqrt(torch.sum(span.to(torch.float32) ** 2)))
    sigma = k["factor"] * max(d_max, 1e-12)
    return 1.0 / (2.0 * sigma * sigma)


def per_layer(name: str, bench: dict) -> list[dict]:
    """The per-layer metrics ``BENCHMARK.json`` reports in cell ``name``."""
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name])]


def end_to_end(name: str, bench: dict) -> list[dict]:
    return [m for m in bench["end_to_end"]
            if name in m.get("workloads", [name])]
