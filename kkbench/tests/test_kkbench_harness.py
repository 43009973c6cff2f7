"""The harness as data, the last line's shape, and the import rules, on
the CPU. The suite's workers import JAX for other files, so the runs here
leave the check of loaded modules to the tests of it below, which run in
processes of their own."""
from __future__ import annotations

import ast
import importlib.util
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest

from kkbench import cell as C
from kkbench import run as R

from .tiny import tiny

KK = Path(C.__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return C.benchmark()


def test_benchmark_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["kkbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_cells_configs_and_metrics_are_found_by_name(bench):
    cfgs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = C.load(w["name"])
        assert cell["config"] == w["config"] and cell["world"] == w["chips"]
        cfg = json.loads((C.ROOT / cfgs[w["config"]]["file"]).read_text())
        assert cfg["name"] == w["config"]
        assert cfg["reduced"] == cfgs[w["config"]]["reduced"]
        for key in ("source", "memory_gb", "reduced", "assumed"):
            assert key in cfg
        importlib.import_module(f"kkbench.gen.{cell['data']['generator']}")
        importlib.import_module(f"kkbench.entries.{cell['entry']}")
        e2e = [m["name"] for m in C.end_to_end(w["name"], bench)]
        layer = [m["name"] for m in C.per_layer(w["name"], bench)]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in e2e + layer:
            assert callable(R.reader(m))
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}


def test_a_cell_added_as_files_is_found(tmp_path, monkeypatch):
    """A later cell is a new workload file: the loader reads it by name."""
    for sub in ("workloads", "configs"):
        (tmp_path / sub).mkdir()
        for f in (KK / sub).glob("*.json"):
            (tmp_path / sub / f.name).write_text(f.read_text())
    wl = dict(json.loads((KK / "workloads" / "noisy-mnist.rff.json")
                         .read_text()), embed_dim=160)
    (tmp_path / "workloads" / "noisy-mnist.rff160.json").write_text(
        json.dumps(wl))
    monkeypatch.setattr(C, "HERE", tmp_path)
    cell = C.load("noisy-mnist.rff160")
    assert cell["embed_dim"] == 160 and cell["n_clusters"] == 10
    assert cell["name"] == "noisy-mnist.rff160"


def test_last_line_shape(bench):
    lines = []
    res = R.run(tiny("noisy-mnist.exact"), bench, seed=2**31 + 11,
                seconds=0.0, trace=False, device="cpu", check_modules=False,
                err=type("E", (), {"write": lambda s, t: lines.append(t),
                                   "flush": lambda s: None})())
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] >= 1
    assert {"fit_rows_per_s", "nmi", "setup_s"} <= set(res["metrics"])
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"}
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for k, v in res["checks"].items():
        assert set(v) == {"value", "limit"}
    text = "".join(lines)
    assert [ln.split()[1] for ln in text.strip().splitlines()[-len(
        res["checks"]):]] == list(res["checks"])
    json.dumps(res)


def test_traced_run_reports_per_layer_metrics(bench):
    res = R.run(tiny("noisy-mnist.rff"), bench, seed=7, seconds=0.0,
                trace=True, device="cpu", check_modules=False)
    assert "outer.inner_iters" in res["metrics"]
    assert "fit_rows_per_s" not in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result():
    """Without as many CUDA devices as the cell asks for: non-zero, and
    nothing on standard output."""
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            "from kkbench.run import main; "
            "sys.exit(main(['--workload', 'noisy-mnist.rff', '--seed', '1', "
            "'--seconds', '1', '--trace', '0']))")
    p = subprocess.run([sys.executable, "-c", code], cwd=C.ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA device" in p.stderr


def test_forbidden_names_compare_whole():
    assert R.forbidden(["repro_torch", "repro_torch.core", "jaxtyping",
                        "reprox", "torch"]) == []
    assert R.forbidden(["jax.numpy", "repro.core", "flax", "jaxlib.xla"]) \
        == ["flax", "jax", "jaxlib", "repro"]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_sources_import_no_jax_and_reference_no_program():
    for p in KK.rglob("*.py"):
        assert not _imports(p) & {"jax", "jaxlib", "flax", "repro"}, p
    for p in (KK / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(p), p


def test_loaded_modules_of_a_run_and_of_the_reference():
    """What importing the harness (and running a tiny cell) loads, and
    what the reference loads, compared by whole top-level names."""
    code = ("import sys, json; sys.path.insert(0, 'src'); "
            "import kkbench.reference.kkmeans, kkbench.reference.rff; "
            "a = sorted({m.split('.')[0] for m in sys.modules}); "
            "from kkbench import run, cell; "
            "from kkbench.tests.tiny import tiny; "
            "run.run(tiny('noisy-mnist.rff'), cell.benchmark(), seed=3, "
            "seconds=0.0, trace=False, device='cpu'); "
            "b = sorted({m.split('.')[0] for m in sys.modules}); "
            "print(json.dumps([a, b]))")
    p = subprocess.run([sys.executable, "-c", code], cwd=C.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    ref, full = json.loads(p.stdout.strip().splitlines()[-1])
    assert not set(ref) & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
    assert "repro_torch" in full
    assert not set(full) & {"jax", "jaxlib", "flax", "repro"}


def test_merged_readings_keep_the_worst_and_what_is_not_a_number():
    from kkbench import check
    got = check.merge([{"cost": 0.1, "predict": 0.2}, {"cost": 0.3},
                       {"medoid_gap": math.nan}, {"medoid_gap": 5.0}])
    assert got["cost"] == 0.3 and got["predict"] == 0.2
    assert got["count"] == 0.0 and math.isnan(got["medoid_gap"])
    assert check.verdict(got, {"cost": 1.0}) is True
    assert check.verdict(got, {"medoid_gap": 1e9}) is False
