"""One run of one cell:

    python3 -m kkbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Set-up makes the cell's inputs on the device
(its training set from its ``data_seed``, the held-out rows ``predict``
labels from ``--seed``), plans the fit, and warms the cell's own shapes (the first
run in a checkout also builds the program's kernels into its
``build/repro_torch/<digest>``). The window then repeats steps (one
planned fit of the whole training set, then ``predict`` on the held-out
rows, ending in a synchronize) until ``--seconds`` have passed and a
cycle is whole: a cell fixes its data (``data_seed``) and a cycle of fit
seeds (``fit_seeds``), and ``--seed`` picks where in the cycle the window
starts and what the reference judges. A fit's work depends on its data and
its k-means++ draws (a class that the seeding splits costs tens of inner
sweeps in the first batches), so every run fits the same set, in another
order. After the
window the plain reference judges a sample of what the window produced
(``check.py``), and the last line of standard output is the result: the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1`` (the window under ``torch.profiler``), the device, and the
compared numbers beside their limits (also the last lines of standard
error).

The run exits non-zero and prints no result without as many CUDA devices
as the cell asks for, and when ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` is loaded once the window has closed."""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if (ROOT / "src").is_dir() and str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """This process's start on the wall clock (``/proc``; the import of
    this module where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


START = process_start()


def forbidden(modules) -> list[str]:
    """Top-level names in ``modules`` that the harness may not hold,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def reader(name: str):
    path = ROOT / "kkbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"kkbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Forbidden(RuntimeError):
    pass


def run(cell: dict, bench: dict, *, seed: int, seconds: float, trace: bool,
        device="cuda", control: str | None = None,
        check_modules: bool = True, err=sys.stderr,
        keep: dict | None = None) -> dict:
    """The run's result (the dict the last line prints); ``keep``, where
    given, receives the window's steps, their seconds and every number the
    reference read (the cell's limits choose which are compared).
    ``control`` (never in a benchmark run): ``"program"`` runs the window
    with the program's TF32 path on, ``"reference"`` judges the reference
    computed in TF32 in the program's place (``check.judge``)."""
    import numpy as np
    import torch

    from . import check, gen, trace as tr, work
    from .cell import gamma as cell_gamma
    from .cell import end_to_end, per_layer
    from .entries import load as load_entry

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def sync():
        if cuda:
            torch.cuda.synchronize()

    data = gen.make(cell["data"], cell["data_seed"], dev, test_seed=seed)
    g = cell_gamma(cell, data.x)
    runner = load_entry(cell["entry"]).Runner(cell, data, g, dev)
    runner.warm()
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if control == "program":      # the program with its TF32 path on
        torch.backends.cuda.matmul.allow_tf32 = True
    outs, walls = [], []
    fits = cell["fit_seeds"]
    start = int(np.random.default_rng([int(seed), 29]).integers(len(fits)))
    setup_s = time.time() - START

    def window():
        from torch.profiler import record_function
        t0 = time.perf_counter()
        with record_function(tr.WINDOW):
            while True:
                t = time.perf_counter()
                with record_function("kkbench:step"):
                    fs = fits[(start + len(outs)) % len(fits)]
                    outs.append(runner.step(fs))
                    sync()
                walls.append(time.perf_counter() - t)
                if (time.perf_counter() - t0 >= seconds
                        and len(outs) % len(fits) == 0):
                    break
        return time.perf_counter() - t0

    if trace:
        elapsed, traced = tr.capture(window)
    else:
        elapsed, traced = window(), None
    torch.backends.cuda.matmul.allow_tf32 = False
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    bad = forbidden(sys.modules) if check_modules else []
    if bad:
        raise Forbidden(f"loaded in the harness's process: {', '.join(bad)}")

    ctx = types.SimpleNamespace(
        cell=cell, shape=runner.shape, outs=outs, walls=walls,
        elapsed=elapsed, setup_s=setup_s, peak=peak, trace=traced,
        data=data, work=work, device=dev)
    wanted = per_layer(cell["name"], bench) if trace else \
        end_to_end(cell["name"], bench)
    metrics = {}
    for m in wanted:
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": False, "attempted": len(outs), "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": runner.shape.world,
                   "memory_peak_bytes": max(setup_peak, peak)},
    }
    if traced is not None:
        result["device"].update(busy_s=traced.busy_s,
                                window_s=traced.window_s)
        result["breakdown"] = {"device_ops": traced.device_ops(),
                               "idle_gaps": traced.idle_gaps()}
    # the reference runs after the peak was read, on the program's freed
    # memory
    del ctx, traced
    runner.close()
    if cuda:
        torch.cuda.empty_cache()
    got = check.judge(cell, data, g, outs, seed,
                      control=control == "reference")
    if keep is not None:
        keep.update(outs=outs, walls=walls, got=got, data=data, gamma=g)
    limits = cell["limits"]
    result["correct"] = check.verdict(got, limits)
    result["checks"] = {k: {"value": got[k], "limit": limits[k]}
                        for k in limits}
    for k in limits:
        print(f"check {k} {got[k]!r} limit {limits[k]!r}", file=err)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m kkbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from .cell import benchmark, load

    bench = benchmark()
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"kkbench: cell {args.workload} needs {chips} CUDA device(s), "
              f"this machine has {have}", file=sys.stderr)
        return 2
    cell = load(args.workload)
    if cell.get("world", 1) != chips:
        print(f"kkbench: cell {args.workload} runs a world of "
              f"{cell.get('world', 1)}, BENCHMARK.json gives {chips} chips",
              file=sys.stderr)
        return 2
    try:
        result = run(cell, bench, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace))
    except Forbidden as e:
        print(f"kkbench: {e}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
