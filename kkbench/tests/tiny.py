"""Tiny versions of the cells for the CPU tests: the same settings at a
few thousand rows, with a planner budget that still splits them into
three batches on the materialized engine, and a cycle of one fit."""
from __future__ import annotations

from kkbench import cell as C


def tiny(name: str, **over) -> dict:
    c = C.load(name)
    d = dict(c["data"])
    if d["generator"] == "noisy_mnist":
        d.update(n_base=1000, n_test=500, n_replicas=6)
        c["memory_gb"] = 0.03       # B = 3, materialize
    else:
        d.update(n_frames=2000, n_test=300)
        c["memory_gb"] = 0.004      # B = 3, materialize
    c["data"] = d
    c["fit_seeds"] = c["fit_seeds"][:1]
    c.update(over)
    return c
