"""A cell of a world of several ranks on the CPU over gloo, through the
harness's own world start-up (``kkbench/world.py``): md-traj.mesh4 at a
tiny size, the program as it is judged correct and reporting the world's
devices, the reference control and each fault the mesh can have judged
not correct (at worlds of 2 and 4 the exchange between the ranks left
out), every follower gone at the end; and the store's rules (rank 0 ends
the window, ranks that made different data stop).

The world runs in a process of its own, with a time limit, since
followers it starts outlive a test that fails in the suite's process."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading

import pytest
import torch
import torch.distributed as dist

from kkbench import cell as C
from kkbench import faults
from kkbench.world import World

SCRIPT = r"""
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(1)
from kkbench import cell as C, run as R
from kkbench.tests.tiny import tiny
from kkbench.world import start

bench = C.benchmark()
for m in bench["per_layer"]:     # the metrics the cell would list
    m.setdefault("workloads", []).append("md-traj.mesh4")
world = start({size}, "cpu")
out = {{"pids": [p.pid for p in world.procs]}}
try:
    cell = tiny("md-traj.mesh4", world={size})
    # an odd batch: its landmarks are drawn, and k-means++ among them
    cell["data"]["n_frames"] = 2001
    for name, over in {runs}:
        spec = {{"cell": cell, "seed": 2**31 + 5, "seconds": 0.0,
                "trace": False, "device": "cpu", "check_modules": False,
                **over}}
        out[name] = R.launch(spec, bench, world=world)
finally:
    world.close()
print(json.dumps(out))
"""


#: the faults of the mesh's timed path at a world above one
MESH_FAULTS = faults.applies(C.load("md-traj.mesh4"))


def _world(size, runs):
    """``runs`` [(name, what the spec changes)] in a world of ``size``."""
    code = SCRIPT.format(root=str(C.ROOT), src=str(C.ROOT / "src"),
                         size=size, runs=repr(runs))
    p = subprocess.run([sys.executable, "-c", code], cwd=C.ROOT,
                       capture_output=True, text=True, timeout=180)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def world_runs():
    return _world(2, [("program", {"trace": True}),
                      ("control", {"control": "reference"}),
                      *((f, {"fault": f}) for f in MESH_FAULTS)])


def test_a_world_cell_is_correct(world_runs):
    r = world_runs["program"]
    assert r["correct"] is True, r["checks"]
    assert r["device"]["count"] == 2 and r["attempted"] >= 1
    # traced: every rank's busy time averaged, rank 0's per-layer metrics
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert "outer.inner_iters" in r["metrics"]
    assert "mesh.collective_share" not in r["metrics"]   # no device ops


@pytest.mark.parametrize("fault", MESH_FAULTS)
def test_a_planted_fault_is_not_correct_in_a_world(world_runs, fault):
    assert world_runs[fault]["correct"] is False, world_runs[fault]["checks"]


def test_the_exchange_left_out_is_not_correct_in_a_world_of_four():
    got = _world(4, [("program", {}), ("exchange", {"fault": "exchange"})])
    assert got["program"]["correct"] is True, got["program"]["checks"]
    assert got["program"]["device"]["count"] == 4
    assert got["exchange"]["correct"] is False, got["exchange"]["checks"]


def test_the_reference_control_is_not_correct_in_a_world(world_runs):
    """The reference in TF32 in the program's place, on the judged batches
    of the program's own step, its units shared out over the ranks."""
    assert world_runs["control"]["correct"] is False


def test_every_follower_has_exited(world_runs):
    for pid in world_runs["pids"]:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def _ranks(size, fn):
    """``fn(world)`` on ``size`` ranks sharing one in-process store, each
    in a thread -> their results (or exceptions) in rank order."""
    store = dist.HashStore()
    got = [None] * size

    def one(r):
        try:
            got[r] = fn(World(r, size, store))
        except Exception as e:       # handed back to the test
            got[r] = e
    ts = [threading.Thread(target=one, args=(r,)) for r in range(size)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    return got


def test_rank_zero_ends_the_window():
    def steps(w):
        n = 0
        # each rank would stop at another step; rank 0's count holds
        while not w.agree(n >= 3 + 2 * w.rank):
            n += 1
        return n
    assert _ranks(3, steps) == [3, 3, 3]


def test_ranks_that_made_different_data_stop():
    def check(flip):
        def fn(w):
            x = torch.arange(12.0).reshape(4, 3)
            # the same rows in another order on rank 1
            w.same(x.flip(0) if flip and w.rank == 1 else x)
            return "same"
        return fn
    assert _ranks(2, check(False)) == ["same", "same"]
    got = _ranks(2, check(True))
    assert all(isinstance(g, RuntimeError) for g in got), got
