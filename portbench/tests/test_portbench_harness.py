"""What the harness promises beside the answers: a configuration, traffic
mix and metric added as files are found with no edit; no JAX in the
process; nothing read from the JAX benchmarks; the card's own checks."""
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"


def test_new_files_are_found_with_no_edit(tmp_path):
    """A later PR adds a configuration, a traffic mix and a per-layer
    metric as files and BENCHMARK.json entries only."""
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((PB / "configs" / "lgd-500k.json").read_text())
    cfg["scale"] = {"n_per_class": 300}
    (tmp_path / "portbench/configs/lgd-tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((PB / "traffic" / "mixed.c8.json").read_text())
    mix["clients"], mix["k"] = 3, [7, 9]
    (tmp_path / "portbench/traffic/odd.c3.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/metrics/serve.queries_seen.py").write_text(
        "def read(w):\n    return float(w.completed)\n")
    bench["configs"].append(dict(bench["configs"][0], name="lgd-tiny",
                                 file="portbench/configs/lgd-tiny.json"))
    bench["workloads"].append({"name": "lgd.odd.c3", "config": "lgd-tiny",
                               "traffic": "odd.c3", "chips": 1, "why": "x"})
    bench["per_layer"].append({
        "name": "serve.queries_seen", "unit": "queries", "better": "higher",
        "source": "program_counter", "layer": "serve loop (serve/spatial)",
        "moves": "qps", "workloads": ["lgd.odd.c3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("lgd.odd.c3", root=tmp_path)
    assert cell.config["scale"] == {"n_per_class": 300}
    assert cell.mix["clients"] == 3
    assert [m["name"] for m in cell.per_layer][-1] == "serve.queries_seen"
    import time
    cell.config["store"]["block"] = 128
    res = harness.run_cell(cell, 3, 1.0, True, "cpu", time.perf_counter(),
                           drain_s=60.0)
    assert res["correct"]
    assert res["metrics"]["serve.queries_seen"]["value"] >= 1


def test_every_metric_and_file_is_named():
    """Each BENCHMARK.json name has its file, and each file its name."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    assert names == {p.stem for p in (PB / "metrics").glob("*.py")}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()
    for w in bench["workloads"]:
        assert (PB / "traffic" / f"{w['traffic']}.json").exists()
        assert w["name"] in {c for m in bench["per_layer"]
                             for c in m["workloads"]}


def test_import_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert harness.banned_modules() == [] or all(
        m.split(".")[0] in {"jax", "jaxlib", "flax", "repro"}
        for m in harness.banned_modules())
    assert "repro_torch_extra" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro.core" in harness.banned_modules()


def test_a_run_loads_no_jax():
    """A whole run of a cell in a fresh process leaves no JAX, jaxlib, flax
    or JAX-package module loaded; no benchmark source imports them, or
    reads the JAX benchmarks' folder."""
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from portbench import harness\n"
        "cell = harness.load_cell('lgd.mixed.c8')\n"
        "cell.config['store']['block'] = 128\n"
        "res = harness.run_cell(cell, 9, 0.5, False, 'cpu', "
        "time.perf_counter(), drain_s=60.0, scale={'n_per_class': 300})\n"
        "assert res['correct']\n"
        "print(harness.banned_modules())\n") % (str(ROOT), str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    import ast
    banned = {"jax", "jaxlib", "flax", "repro"}
    for src in PB.rglob("*.py"):
        tree = ast.parse(src.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not banned & set(tops), (src, tops)
        assert "benchmarks/" not in src.read_text() or src.name == \
            "test_portbench_harness.py", src


def test_cli_needs_the_card():
    """Without CUDA the command exits nonzero and prints no result."""
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "lgd.mixed.c8",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    """One short run of each cell on the card: a result line, correct."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        out = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload", w["name"],
             "--seed", "4242424242", "--seconds", "3", "--trace", "0"],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-4000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"] and res["device"]["platform"] == "gpu"
