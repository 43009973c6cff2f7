"""The readings the limits of a cell's comparison are set from, in one
process: for each seed, one step of the program (the window's own step at
the cell's size, on data drawn from that seed and a fit seed drawn from
it, so the readings range wider than the cell's fixed data) judged by the
reference, and after it each control or fault asked for, judged the same
way (the reference control on the program's own step, judged beside it).
The benchmark's own runs never run this.

    python3 -m kkbench.calibrate --workload <cell> --seeds 11,12,13 \\
        [--control program,reference] [--fault swapped] [--out FILE]
    python3 -m kkbench.calibrate --workload <cell> --cycle 1 [--out FILE]

Controls: ``program``, the same step with the program's TF32 path on
(``torch.backends.cuda.matmul.allow_tf32``: its materialized Gram
contractions and the RFF embedding and Lloyd products run on the tensor
cores in TF32); ``reference`` (exact cells), the reference computed in
TF32, which rounds K itself, in the program's place on the judged batches
of the program's step (``check.judge(control=True)``). A fault
(``kkbench/faults.py``) is planted in the program for one more step.

``--cycle 1`` reads what a benchmark run of an exact cell can judge: the
cell's own data and each fit of its cycle, every batch judged (a run
judges a sample of three).

A cell of a world above one runs in a world of its own (``world.py``),
every seed's runs posted to all of its ranks, which share out the
reference's units.

Each reading is a JSON line on standard output (and in ``--out``)."""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import check
from . import run as run_mod
from .cell import benchmark, load
from .world import start


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m kkbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--cycle", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default="",
                    help="comma-separated: program, reference")
    ap.add_argument("--fault", default="",
                    help="comma-separated names of kkbench/faults.py")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kkbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench, cell = benchmark(), load(args.workload)
    if cell.get("world", 1) > 1:
        run_mod.pin_threads(cell["world"], "kkbench.calibrate",
                            sys.argv[1:] if argv is None else list(argv))
    controls = [k for k in args.control.split(",") if k]
    planted = [k for k in args.fault.split(",") if k]
    out = open(args.out, "a") if args.out else None
    world = None

    def emit(seed, kind, correct, got, t, keep, r=None):
        line = json.dumps({
            "workload": args.workload, "seed": seed, "kind": kind,
            "correct": correct, "checks": got,
            "metrics": {k: v["value"] for k, v in r["metrics"].items()}
            if r else {},
            "seconds": time.time() - t,
            "iters": [h.inner_iters for h in keep["outs"][0].history],
            "step_s": keep["walls"][0],
            "kind_of_device": torch.cuda.get_device_name(0)})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def one_run(c, seed, keep, **kw):
        spec = {"cell": c, "seed": seed, "seconds": 0.0, "trace": False,
                "device": "cuda", **kw}
        return run_mod.launch(spec, bench, world=world, keep=keep)

    try:
        if cell.get("world", 1) > 1:
            world = start(cell["world"], "cuda")
        if args.cycle:
            for fs in cell["fit_seeds"]:
                t, keep = time.time(), {}
                one_run(dict(cell, fit_seeds=[fs]), fs, keep,
                        every_batch=True)
                pred = check.merge(d for u, d in keep["units"]
                                   if u[0] == "predict")
                for u, d in keep["units"]:
                    if u[0] != "batch":
                        continue
                    got = check.merge([d, pred])
                    emit(fs, f"cycle_batch_{u[2]}",
                         check.verdict(got, cell["limits"]), got, t, keep)
                keep.clear()
        for seed in (int(s) for s in args.seeds.split(",") if s):
            one = dict(cell, data_seed=seed, fit_seeds=[
                int(np.random.SeedSequence([seed, 1]).generate_state(1)[0])])
            runs = [("program", None, None)]
            if "program" in controls:
                runs.append(("control_program", "program", None))
            runs += [(f"fault_{f}", None, f) for f in planted]
            for kind, control, fault in runs:
                t, keep = time.time(), {}
                both = kind == "program" and "reference" in controls
                r = one_run(one, seed, keep, control=control, fault=fault,
                            with_control=both)
                emit(seed, kind, r["correct"], keep["got"], t, keep, r)
                if both:
                    got = keep["got_control"]
                    emit(seed, "control_reference",
                         check.verdict(got, one["limits"]), got, t, keep)
                keep.clear()
    finally:
        if world is not None:
            world.close()
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
