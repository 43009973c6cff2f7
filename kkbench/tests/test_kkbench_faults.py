"""The comparison shown to fail: the control (the reference put in the
program's place, computed in TF32) and each fault the cells can have,
planted in the program (``kkbench/faults.py``) under a whole run on the
CPU (the harness's look for a chip skipped), must come out ``correct:
false``; the program as it is must come out true. The world-of-one cells have no exchange between chips
to leave out. On the card, ``test_control_on_the_card`` runs the program's
own TF32 path."""
from __future__ import annotations

import types

import pytest
import torch

from kkbench import cell as C
from kkbench import check, faults, gen
from kkbench import run as R
from kkbench.entries import StepOut
from kkbench.reference import kkmeans, rff

from .tiny import tiny

SEED = 2**31 + 101
CELLS = {"exact": ("noisy-mnist.exact", {}),
         "mesh": ("noisy-mnist.exact", {"entry": "mesh"}),
         "rff": ("noisy-mnist.rff", {})}


def _run(which):
    name, over = CELLS[which]
    return R.run(tiny(name, **over), C.benchmark(), seed=SEED, seconds=0.0,
                 trace=False, device="cpu", check_modules=False,
                 err=open("/dev/null", "w"))


@pytest.mark.parametrize("which", sorted(CELLS))
def test_the_program_as_it_is_is_correct(which):
    assert _run(which)["correct"] is True


@pytest.mark.parametrize("which,fault", [
    (w, f) for w in sorted(CELLS) for f in faults.APPLIES[w]])
def test_a_planted_fault_is_not_correct(monkeypatch, which, fault):
    faults.FAULTS[fault](monkeypatch, which)
    assert _run(which)["correct"] is False


def _control_outs(cell, data, g, seed):
    """The reference computed in TF32, in the program's place: one step's
    outputs in the shapes the program gives them."""
    st = types.SimpleNamespace
    if cell["method"] == "rff":
        w, b, cents, counts, cost, iters = rff.fit(
            data.x, g, cell["n_clusters"], cell["embed_dim"],
            cell["max_inner_iters"], seed=seed, tf32=True)
        labels = torch.argmin(rff.sqdist(rff.embed(data.x_test, w, b,
                                                   tf32=True), cents,
                                         tf32=True), dim=1)
        state = st(centroids=cents.float(), cardinalities=counts.float())
        return [StepOut(seed=seed, states=[state], labels=labels,
                        history=[st(cost=cost, counts=counts.numpy(),
                                    inner_iters=iters)],
                        rows=[data.x.shape[0]], fmap=st(w=w, b=b))]
    from kkbench.entries.fit_dataset import plan
    n_b = plan(cell, *data.x.shape, 1).b
    med, card, hist, states = kkmeans.fit(
        data.x, g, cell["n_clusters"], n_b, cell["max_inner_iters"],
        seed=seed, tf32=True)
    return [StepOut(
        seed=seed,
        states=[st(medoids=m, cardinalities=c.float()) for m, c in states],
        history=[st(cost=cost, counts=cnt.numpy(), inner_iters=it)
                 for cost, cnt, it in hist],
        labels=kkmeans.predict(data.x_test, med, g, tf32=True),
        rows=[len(range(i, data.x.shape[0], n_b)) for i in range(n_b)])]


@pytest.mark.parametrize("name", ["noisy-mnist.exact", "noisy-mnist.rff",
                                  "md-traj.exact"])
def test_the_control_is_not_correct(name):
    cell = tiny(name)
    data = gen.make(cell["data"], SEED, "cpu", SEED)
    g = C.gamma(cell, data.x)
    got = check.judge(cell, data, g, _control_outs(cell, data, g, 12345),
                      SEED)
    assert check.verdict(got, cell["limits"]) is False, got


@pytest.mark.parametrize("name", ["noisy-mnist.exact", "md-traj.exact"])
def test_the_reference_control_in_the_programs_place_is_not_correct(name):
    """The control as the calibration reads it at the cells' size: the
    reference in TF32 on the judged batches of the program's own step,
    from the program's entering states."""
    kw = dict(seed=SEED, seconds=0.0, trace=False, device="cpu",
              check_modules=False, err=open("/dev/null", "w"))
    assert R.run(tiny(name), C.benchmark(), control="reference",
                 **kw)["correct"] is False


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["md-traj.exact", "noisy-mnist.rff"])
def test_control_on_the_card(cuda, name):
    """The program with its TF32 path switched on, at a size a test run
    holds, is judged not correct; without it, correct."""
    cell = tiny(name)
    d = dict(cell["data"])
    if d["generator"] == "noisy_mnist":
        d.update(n_base=6000, n_test=2000, n_replicas=4)
    else:
        d.update(n_frames=40000, n_test=4000)
    cell.update(data=d, memory_gb=0.5)
    kw = dict(seed=SEED, seconds=0.0, trace=False, device=cuda,
              check_modules=False, err=open("/dev/null", "w"))
    assert R.run(cell, C.benchmark(), **kw)["correct"] is True
    assert R.run(cell, C.benchmark(), control="program",
                 **kw)["correct"] is False


@pytest.mark.gpu
def test_reference_control_on_the_card(cuda):
    """On noisy MNIST's exact path the program's TF32 path reads as the
    program does; the reference in TF32 in its place, at a size a test run
    holds, is judged not correct, and the program correct."""
    cell = tiny("noisy-mnist.exact")
    cell["data"] = dict(cell["data"], n_base=6000, n_test=2000, n_replicas=4)
    cell["memory_gb"] = 0.5
    kw = dict(seed=SEED, seconds=0.0, trace=False, device=cuda,
              check_modules=False, err=open("/dev/null", "w"))
    keep = {}
    assert R.run(cell, C.benchmark(), keep=keep, **kw)["correct"] is True
    got = check.judge(cell, keep["data"], keep["gamma"], keep["outs"], SEED,
                      control=True)
    assert check.verdict(got, cell["limits"]) is False, got
