"""repro_torch.launch: env (the process variables), dryrun_cluster on a
fake world, and the multi-process smoke.

``dryrun_cluster --all`` costs one Alg.1 sweep of every mode on the
single-pod (256 ranks) and multi-pod (512) fake worlds in a subprocess:
every cell must be ok, with one all_gather and one all_reduce per sweep,
the reference's ``model_flops_total`` formula
(``src/repro/launch/dryrun_cluster.py:199-202``) and no byte allocated.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import env

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("2d", "2d-bf16k", "fused", "paper-1d")   # the reference's MODES


def _run(args, timeout=240):
    e = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    return subprocess.run([sys.executable, "-m", *args], env=e, cwd=_ROOT,
                          capture_output=True, text=True, timeout=timeout)


# ---------------------------------------------------------------------------
# env


def test_configure_merges_without_overwriting(monkeypatch):
    names = [name for name, _ in env.PROCESS_VARIABLES]
    for name in names:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    applied = env.configure()
    for name, value in env.PROCESS_VARIABLES:
        assert os.environ[name] == value == applied[name]
    assert env.configure() == applied       # idempotent
    monkeypatch.setenv(names[0], "7")       # the caller's value stays
    assert env.configure()[names[0]] == "7" == os.environ[names[0]]
    assert "PYTORCH_CUDA_ALLOC_CONF" not in applied
    # scheduling variables stay unset until a measurement backs them
    assert not {"CUDA_DEVICE_MAX_CONNECTIONS",
                "TORCH_NCCL_HIGH_PRIORITY"} & set(applied)


def test_configure_warns_when_too_late(monkeypatch):
    for name, _ in env.PROCESS_VARIABLES:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.warns(RuntimeWarning, match="will not take effect"):
        env.configure()
    # nothing left to change: no warning
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        env.configure()


def test_device_from_argv():
    assert env.device_from_argv(["--n", "3", "--device", "cpu"]) == "cpu"
    assert env.device_from_argv(["--device=cuda:1"]) == "cuda:1"
    assert env.device_from_argv(["--n", "3"]) is None


def test_set_device(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert env.set_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        env.set_device()


# ---------------------------------------------------------------------------
# dryrun_cluster on a fake world


@pytest.fixture(scope="module")
def dryrun_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    proc = _run(["repro_torch.launch.dryrun_cluster", "--all", "--out",
                 str(out)])
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    return {f: json.load(open(out / f)) for f in os.listdir(out)}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["sp", "mp"])
@pytest.mark.parametrize("mode", MODES)
def test_dryrun_cluster_cell(dryrun_cells, mode, multi_pod):
    assert len(dryrun_cells) == 8
    d = dryrun_cells[f"kkmeans-{mode}__minibatch_1m__"
                     f"{'mp' if multi_pod else 'sp'}.json"]
    assert d["ok"] and d["mesh"] == ("2x16x16" if multi_pod else "16x16")
    p = d["problem"]
    assert p["world"] == (512 if multi_pod else 256)
    # Alg.1's bound: one label all_gather and one all_reduce a sweep
    assert d["collectives"]["counts"] == {"all-gather": 1, "all-reduce": 1}
    n, L, dd, c = p["n_rows"], p["n_landmarks"], p["d"], p["c"]
    gram_f, fmat = 2.0 * n * L * dd, 2.0 * n * L * c
    assert d["model_flops_total"] == fmat + (
        gram_f if mode == "fused" else gram_f / 20.0)
    assert d["memory_analysis"]["allocated_bytes"] == 0
    la = d["loop_aware"]
    assert la["flops_per_device"] > 0 and la["bytes_per_device"] > 0
    # per-sweep collective bytes stay far below the device traffic
    assert la["collective_bytes"] < 0.05 * la["bytes_per_device"]
    assert "trace_seconds" in d and "compile_seconds" not in d


def test_dryrun_cluster_refuses_a_world_that_is_up(monkeypatch):
    from repro_torch.launch import dryrun_cluster
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="own fake world"):
        dryrun_cluster.lower_cluster("2d")


def test_smoke_mp_two_processes(tmp_path):
    log = tmp_path / "smoke.jsonl"
    proc = _run(["repro_torch.launch.dryrun_cluster", "--smoke-mp", "2",
                 "--device", "cpu", "--obs", str(log)])
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "[ok] multi-process smoke: 2 processes clean on cpu" \
        in proc.stdout
    events = [json.loads(line) for line in log.read_text().splitlines()]
    assert events[0]["kind"] == "header" and events[0]["nprocs"] == 2


def test_smoke_mp_defaults_to_the_card(monkeypatch):
    """Without a card the driver raises naming --device cpu before it
    spawns; on the card it refuses more ranks than visible cards."""
    from repro_torch.launch import dryrun_cluster, smoke_mp
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun_cluster.main(["--smoke-mp", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--device cpu"):
        smoke_mp.rank_device(None, 0, 2)
    assert smoke_mp.rank_device(None, 0, 1) == torch.device("cuda", 0)
    assert smoke_mp.rank_device("cpu", 1, 2) == torch.device("cpu")
