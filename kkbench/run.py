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

A cell of a world above one (``chips`` 4) runs as that many processes,
rank r on ``cuda:r`` (``world.py``): this process is rank 0 and starts the
others, which run the same set-up and steps, trace their own devices
with ``--trace 1`` (rank 0's trace gives the per-layer metrics, every
rank's the busy time) and judge a share of the sample; rank 0 ends the
window, reads the largest peak over the ranks, and prints once every
other rank has exited.

The run exits non-zero and prints no result without as many CUDA devices
as the cell asks for, and when ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` is loaded once the window has closed, in any rank."""
from __future__ import annotations

import argparse
import importlib.util
import io
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


def pin_threads(size: int, module: str, argv: list) -> None:
    """Rank 0 of a world of ``size`` on one host: run ``module`` again in
    this process (``os.execve``), with ``OMP_NUM_THREADS`` at a rank's
    share of the host's cores, unless it is set so already. Every rank
    then starts torch with that many host threads (the others inherit
    the environment): the ranks' pools do not oversubscribe the host that
    stages every batch. PERF.md §6 gives the readings that chose it."""
    want = str(max(1, len(os.sched_getaffinity(0)) // size))
    if os.environ.get("OMP_NUM_THREADS") != want:
        sys.stdout.flush()
        sys.stderr.flush()
        os.execve(sys.executable, [sys.executable, "-m", module, *argv],
                  dict(os.environ, OMP_NUM_THREADS=want))


class Forbidden(RuntimeError):
    pass


def run(cell: dict, bench: dict, *, seed: int, seconds: float, trace: bool,
        device="cuda", control: str | None = None,
        check_modules: bool = True, err=sys.stderr,
        keep: dict | None = None, world=None, every_batch: bool = False,
        with_control: bool = False) -> dict:
    """The run's result (the dict the last line prints); ``keep``, where
    given, receives the window's steps, their seconds and every number the
    reference read (the cell's limits choose which are compared).
    ``control`` (never in a benchmark run): ``"program"`` runs the window
    with the program's TF32 path on, ``"reference"`` judges the reference
    computed in TF32 in the program's place (``check.judge``);
    ``with_control`` also keeps the latter's numbers for the same steps
    (``keep["got_control"]``), and ``every_batch`` judges every batch of
    every step (``keep["units"]``: each unit with its numbers).

    ``world`` (``kkbench/world.py``): this process's rank in a world of
    several, each rank on its own device running the same steps and
    tracing its own device; rank 0 ends the window, reads the per-layer
    metrics from its trace (the busy time is every rank's mean), and alone
    returns the result. The ranks share out the reference's units after
    the window."""
    import numpy as np
    import torch

    from . import check, gen, trace as tr, work
    from .cell import gamma as cell_gamma
    from .cell import end_to_end, per_layer
    from .entries import load as load_entry
    from .world import World

    w = world or World()
    dev = torch.device(device) if w.size == 1 else \
        w.device(torch.device(device).type)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    data = gen.make(cell["data"], cell["data_seed"], dev, test_seed=seed)
    if w.size > 1:
        w.same(data.x, data.x_test)
    g = cell_gamma(cell, data.x)
    runner = load_entry(cell["entry"]).Runner(cell, data, g, dev)
    runner.warm()
    sync()
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
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
                if w.agree(time.perf_counter() - t0 >= seconds
                           and len(outs) % len(fits) == 0):
                    break
        return time.perf_counter() - t0

    if trace:
        elapsed, traced = tr.capture(window)
    else:
        elapsed, traced = window(), None
    torch.backends.cuda.matmul.allow_tf32 = False
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    after = w.exchange("after", {
        "peak": peak, "setup_peak": setup_peak,
        "busy_s": traced.busy_s if traced is not None else None,
        "loaded": forbidden(sys.modules) if check_modules else []})
    bad = [f"{m} (rank {r})" for r, a in enumerate(after)
           for m in a["loaded"]]
    if bad:
        raise Forbidden(f"loaded in the harness's process: {', '.join(bad)}")

    result = None
    if w.rank == 0:
        ctx = types.SimpleNamespace(
            cell=cell, shape=runner.shape, outs=outs, walls=walls,
            elapsed=elapsed, setup_s=setup_s,
            peak=max(a["peak"] for a in after), trace=traced, data=data,
            work=work, device=dev)
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
                       "kind": torch.cuda.get_device_name(0) if cuda
                       else "cpu",
                       "count": runner.shape.world,
                       "memory_peak_bytes": max(max(a["peak"],
                                                    a["setup_peak"])
                                                for a in after)},
        }
        if traced is not None:
            result["device"].update(
                busy_s=sum(a["busy_s"] for a in after) / len(after),
                window_s=traced.window_s)
            result["breakdown"] = {"device_ops": traced.device_ops(),
                                   "idle_gaps": traced.idle_gaps()}
        del ctx
    # the reference runs after the peak was read, on the program's freed
    # memory
    del traced
    runner.close()
    if cuda:
        torch.cuda.empty_cache()
    judged = []
    got = check.judge(cell, data, g, outs, seed,
                      control=control == "reference", every=every_batch,
                      world=w, judged=judged)
    if with_control:
        ctl = check.judge(cell, data, g, outs, seed, control=True, world=w)
    if keep is not None:
        keep.update(outs=outs, walls=walls, got=got, data=data, gamma=g,
                    units=judged)
        if with_control:
            keep["got_control"] = ctl
    if w.rank:
        return {"rank": w.rank}
    limits = cell["limits"]
    result["correct"] = check.verdict(got, limits)
    result["checks"] = {k: {"value": got[k], "limit": limits[k]}
                        for k in limits}
    for k in limits:
        print(f"check {k} {got[k]!r} limit {limits[k]!r}", file=err)
    return result


#: the keys of a posted run that ``run`` takes
RUN_KEYS = ("seed", "seconds", "trace", "device", "control", "check_modules",
            "every_batch", "with_control")


def run_spec(spec: dict, bench: dict, *, world=None, keep=None,
             err=sys.stderr) -> dict:
    """``run`` of a posted run (``spec``: its cell, ``RUN_KEYS`` and a
    ``fault`` of ``kkbench/faults.py`` to plant, or none)."""
    kw = {k: spec[k] for k in RUN_KEYS if k in spec}
    if not spec.get("fault"):
        return run(spec["cell"], bench, world=world, keep=keep, err=err,
                   **kw)
    from . import faults
    with faults.planted(spec["fault"], spec["cell"]):
        return run(spec["cell"], bench, world=world, keep=keep, err=err,
                   **kw)


def launch(spec: dict, bench: dict, *, world=None, keep=None,
           err=sys.stderr) -> dict:
    """Rank 0: post ``spec`` to the world's other ranks and run it."""
    if world is not None:
        world.begin(spec)
    return run_spec(spec, bench, world=world, keep=keep, err=err)


def _follow(spec: dict, world) -> None:
    from .cell import benchmark
    try:
        run_spec(spec, benchmark(), world=world)
    except Forbidden as e:      # rank 0 names it and ends the world
        print(f"kkbench: rank {world.rank}: {e}", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m kkbench.run")
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a world that another run of this module started
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank:
        from .world import follow
        return follow(args.rank, args.store, _follow)
    if None in (args.workload, args.seed, args.seconds):
        ap.error("--workload, --seed and --seconds are required")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    if chips > 1:
        pin_threads(chips, "kkbench.run",
                    sys.argv[1:] if argv is None else list(argv))

    import torch

    from .cell import load
    from .world import start

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
    spec = {"cell": cell, "seed": args.seed, "seconds": args.seconds,
            "trace": bool(args.trace), "device": "cuda"}
    world, checks = None, io.StringIO()
    try:
        if chips > 1:
            world = start(chips, "cuda")
        result = launch(spec, bench, world=world, err=checks)
    except Forbidden as e:
        print(f"kkbench: {e}", file=sys.stderr)
        return 3
    finally:
        if world is not None:
            world.close()
    # every other rank has exited: the compared numbers are the last lines
    # of standard error, the result the last line of standard output
    sys.stderr.write(checks.getvalue())
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
