"""Assignment-serving latency benchmark, the port of
``benchmarks/serve_bench.py``.

    python -m repro_torch.launch.serve_bench [--full] [--device cpu]
                                             [--out results.json]
                                             [--obs log.jsonl]

Fits a small RFF model on blobs and freezes it (``launch.serve``'s
``synth_artifact``, the reference benchmark's model), builds an
``AssignService`` (one captured CUDA graph per bucket on the card) and
drives an open loop: request i arrives at i / qps whatever the service is
doing, so queueing delay counts. The grid is two offered rates x requests
of 1 and 64 rows (two buckets); each cell reports p50/p99 latency (arrival
to labels on the host) and rows/s, and, where the service has a
``JsonlRecorder``, the p50 of its requests' queue and compute seconds,
read back from the recorder's ``serve/request`` events (the reference
benchmark folds the same log). The record also holds the programs
(graphs), the warm seconds,
``artifact_nbytes`` and the planner's ``serve_footprint_bytes`` at the
largest bucket, and the device it ran on. ``bench(..., eager=True)`` runs
the same loop with each request labelled on arrival by the offline
``predict_frozen`` (eager launches at the same bucket shapes), the
baseline the graphs are held against. ``open_loop`` and ``bench`` are what
``chip_smoke.py`` runs on its own artifacts.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.core.memory import serve_footprint_bytes
from repro_torch.kernels.precision import resolve_precision
from repro_torch.launch.serve import synth_artifact
from repro_torch.obs import JsonlRecorder, export
from repro_torch.serving import AssignService, artifact_nbytes, predict_frozen

#: the open loop sleeps to within this many seconds of an arrival, then
#: spins
SPIN_S = 2e-3


def open_loop(svc: AssignService, xs: list, qps: float):
    """Request i arrives at i / qps; the service ticks whenever requests
    wait. Returns (latencies [s], the uids in the same order, elapsed wall
    seconds)."""
    arrive = [i / qps for i in range(len(xs))]
    uid2arr, lat, uids = {}, [], []
    t0 = time.perf_counter()
    submitted = 0
    while len(lat) < len(xs):
        now = time.perf_counter() - t0
        while submitted < len(xs) and arrive[submitted] <= now:
            uid2arr[svc.submit(xs[submitted])] = arrive[submitted]
            submitted += 1
        if submitted > len(lat):
            for uid in svc.step():
                lat.append((time.perf_counter() - t0) - uid2arr[uid])
                uids.append(uid)
        elif submitted < len(xs):
            _sleep_until(t0 + arrive[submitted])
    return lat, uids, time.perf_counter() - t0


def request_split(path: str, uids) -> tuple[list, list]:
    """(queue seconds, compute seconds) of the requests ``uids`` from the
    ``serve/request`` events of a recorder's log."""
    want = set(uids)
    got = [e for e in export.read_events(path)
           if e.get("name") == "serve/request" and e.get("uid") in want]
    return ([e["queue_seconds"] for e in got],
            [e["compute_seconds"] for e in got])


def _sleep_until(t: float) -> None:
    """Sleep to within SPIN_S of host time ``t``, then return: a sleep
    overshoots by up to a millisecond on a shared host, which would count
    as queueing delay."""
    wait = t - time.perf_counter()
    if wait > SPIN_S:
        time.sleep(wait - SPIN_S)


def eager_loop(art, xs: list, qps: float):
    """The eager baseline of ``open_loop``: request i arrives at i / qps
    and is labelled on arrival by ``predict_frozen`` (eager launches at the
    same bucket shapes), one request at a time. Returns what ``open_loop``
    returns."""
    lat, compute = [], []
    t0 = time.perf_counter()
    for i, x in enumerate(xs):
        arrive = t0 + i / qps
        _sleep_until(arrive)
        while time.perf_counter() < arrive:
            pass
        t1 = time.perf_counter()
        predict_frozen(art, x).cpu()
        t2 = time.perf_counter()
        lat.append(t2 - arrive)
        compute.append(t2 - t1)
    return lat, compute, time.perf_counter() - t0


def bench(svc: AssignService, *, qps_levels=(100.0, 500.0),
          row_sizes=(1, 64), n_req: int = 200, seed: int = 0,
          eager: bool = False) -> dict:
    """The open-loop grid over one service -> the benchmark record;
    ``eager`` runs ``eager_loop`` on its artifact instead. The queue /
    compute split of the service's requests comes from its recorder's log
    (flushed at the end of every cell) where it has one, else is None."""
    art = svc.artifact
    d, c, m = art.in_dim, art.n_clusters, art.dim
    log = getattr(svc.rec, "path", None)
    rng = np.random.default_rng(seed)
    cells = {}

    def p50_ms(v):
        return float(np.percentile(v, 50) * 1e3) if v else None

    for rows in row_sizes:
        xs = [rng.normal(size=(rows, d)).astype(np.float32)
              for _ in range(n_req)]
        for qps in qps_levels:
            queue, compute = [], []
            if eager:
                lat, compute, elapsed = eager_loop(art, xs, qps)
            else:
                lat, uids, elapsed = open_loop(svc, xs, qps)
                if log is not None:
                    svc.rec.batch_boundary(len(cells))
                    queue, compute = request_split(log, uids)
            p50, p99 = np.percentile(lat, [50, 99])
            cells[f"qps{qps:g}_rows{rows}"] = {
                "offered_qps": qps, "rows_per_request": rows,
                "requests": n_req, "p50_ms": float(p50 * 1e3),
                "p99_ms": float(p99 * 1e3),
                "queue_p50_ms": p50_ms(queue),
                "compute_p50_ms": p50_ms(compute),
                "rows_per_s": float(rows * n_req / elapsed)}
    dev = art.device
    return {
        "kind": art.kind, "precision": art.precision,
        "loop": "eager" if eager else "service",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "buckets": list(svc.cfg.buckets),
        "compiled_programs": svc.compiled_programs,
        "warm_seconds": svc.warm_seconds,
        "artifact_bytes": artifact_nbytes(art),
        "predicted_bytes": serve_footprint_bytes(
            c, m, d, method=art.kind,
            q_tile=resolve_precision(art.precision).tile_itemsize,
            bucket=max(svc.cfg.buckets)),
        "cells": cells}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="the larger model, 200 requests a cell, 100 and "
                    "500 QPS (default: 40 requests, 50 and 200 QPS)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    ap.add_argument("--out", default=None, help="write the record here")
    ap.add_argument("--obs", default=None, metavar="PATH",
                    help="keep the service's flight-recorder JSONL here "
                    "(default: a temporary file)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        path = args.obs or os.path.join(tmp, "serve_bench.jsonl")
        art = synth_artifact(args.device, full=args.full)
        obs = JsonlRecorder(path, header=export.run_header(
            device=art.device, entry="launch.serve_bench", full=args.full))
        with obs:
            svc = AssignService(art, recorder=obs)
            rec = bench(svc, qps_levels=(100.0, 500.0) if args.full
                        else (50.0, 200.0), n_req=200 if args.full else 40)
        rec["obs"] = export.summarize(path)
    for name, cell in rec["cells"].items():
        print(f"[serve_bench] {name}: p50 {cell['p50_ms']:.3f} ms, p99 "
              f"{cell['p99_ms']:.3f} ms, {cell['rows_per_s']:.0f} rows/s "
              f"(queue p50 {cell['queue_p50_ms']:.3f} ms, compute p50 "
              f"{cell['compute_p50_ms']:.3f} ms)")
    print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rec, fh, indent=1)
    return rec


if __name__ == "__main__":
    main()
