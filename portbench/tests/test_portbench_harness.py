"""What the harness promises beside the answers: a configuration, traffic
mix and metric added as files are found with no edit; no JAX in the
process; nothing read from the JAX benchmarks; the card's own checks."""
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from portbench import datagen, harness, traffic

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


# the files a later change adds for a new query shape: a generator that
# adds range selections to the LGD-shaped data, the shape, a metric that
# reads a program span and a counter
GENERATOR = '''"""LGD-shaped data, its Q1-Q8 and two range selections."""
import dataclasses

from portbench import datagen


@dataclasses.dataclass(frozen=True)
class Selection:
    select: tuple
    patterns: tuple
    geo: datagen.V
    dist: float          # the window's half side
    extent: float
    k: int = 0
    shape: str = "range_select"


def make(n_per_class, seed):
    ds = datagen.make_lgd(n_per_class, seed)
    ids = {t: i for i, t in enumerate(ds.terms, start=1)}
    V = datagen.V

    def select(cls):
        return Selection(
            (V("place"),),
            ((V("r"), V("place"), V("typePred"), ids[cls]),
             (None, V("r"), ids["hasConfidence"], V("conf")),
             (None, V("place"), ids["hasGeometry"], V("g"))),
            V("g"), 10.0, ds.extent)
    return dataclasses.replace(ds, templates=ds.templates + [
        select("class:hotel"), select("class:park")])
'''

SHAPE = '''"""Every row of one class whose geometry has a point inside a window
centred on the request's place: all rows, score 0, canonical order."""
import collections

import numpy as np

READS = ("dist", "pos")


def window(tpl, req, share=1.0):
    x, y = req.pos[0] * tpl.extent, req.pos[1] * tpl.extent
    h = req.dist * share
    return (x - h, y - h, x + h, y + h)


def query(prog, tpl, req):
    rt = prog.rt
    return rt.Query(select=prog.select(tpl), patterns=prog.patterns(tpl),
                    spatial=rt.SpatialFilter(rt.Var(tpl.geo.name),
                                             window=window(tpl, req, 1.0)),
                    ranking=None)


def answer(ref, tpl, reqs):
    rel = ref.bgp(list(tpl.patterns))
    has, row = ref.geometry_rows(rel[tpl.geo.name])
    pts = ref.points[row]
    x0, y0, x1, y1 = window(tpl, reqs[0])
    inside = has & ((pts[..., 0] >= x0) & (pts[..., 0] <= x1)
                    & (pts[..., 1] >= y0) & (pts[..., 1] <= y1)).any(axis=1)
    keys = np.stack([rel[v.name] for v in tpl.select], axis=1)[inside]
    return keys[np.lexsort(keys.T[::-1])]


def judge(ans, scores, keys, req, tpl):
    got = collections.Counter(map(tuple, np.asarray(keys).tolist()))
    want = collections.Counter(map(tuple, ans.tolist()))
    wrong = int(np.count_nonzero(np.asarray(scores) != 0))
    return (wrong + sum((got - want).values()),
            sum((want - got).values()), 0.0)


def served(ref, tpl, reqs):
    return [(np.zeros(len(a)), a)
            for a in (answer(ref, tpl, [r]) for r in reqs)]
'''

METRIC = '''"""Admissions (`serve.admit` spans) per share-cache lookup."""


def read(w):
    if w.program_spans is None or "serve.admit" not in w.program_names:
        return None
    admits = int((w.program_spans["name"]
                  == w.program_names.index("serve.admit")).sum())
    lookups = sum(v for k, v in w.program_counts.items()
                  if k.startswith("share."))
    return admits / lookups if lookups else None
'''


def _with_a_new_shape(root: pathlib.Path, shape: str) -> harness.Cell:
    """`root` holds a copy of portbench and BENCHMARK.json with, as new
    files and entries only, the generator, `shape` as
    shapes/range_select.py, a mix that draws places, a configuration, a
    cell and the metric."""
    shutil.copytree(PB, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = root / "portbench"
    (pb / "generators").mkdir(exist_ok=True)
    (pb / "generators/lgd_places.py").write_text(GENERATOR)
    (pb / "shapes/range_select.py").write_text(shape)
    (pb / "metrics/serve.admits_per_share_lookup.py").write_text(METRIC)
    cfg = json.loads((PB / "configs" / "lgd-500k.json").read_text())
    cfg.update(name="lgd-places", generator="lgd_places",
               scale={"n_per_class": 300})
    cfg["store"]["block"] = 128
    (pb / "configs/lgd-places.json").write_text(json.dumps(cfg))
    (pb / "traffic/places.c3.json").write_text(json.dumps({
        "engine": "serve", "clients": 3, "max_slots": 3,
        "templates": [1, 9, 10], "dist": "template", "k": [5, 20],
        "pos": True}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="lgd-places",
                                 file="portbench/configs/lgd-places.json"))
    bench["workloads"].append({"name": "lgd.places.c3",
                               "config": "lgd-places",
                               "traffic": "places.c3", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({
        "name": "serve.admits_per_share_lookup", "unit": "1",
        "better": "lower", "source": "program_span",
        "layer": "serve loop (serve/spatial)", "moves": "qps",
        "workloads": ["lgd.places.c3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return harness.load_cell("lgd.places.c3", root=root)


def test_a_new_shape_is_added_as_files(tmp_path):
    """A generator, a query shape that reads each request's place, a mix
    that draws places, a configuration, a cell and a metric that reads a
    program span and a counter, added as files and BENCHMARK.json entries
    only: the cell is correct, and wrong with a window a tenth smaller."""
    import time
    cell = _with_a_new_shape(tmp_path / "sound", SHAPE)
    ds = datagen.make(dict(cell.config), 5, cell.root)
    assert [t.shape for t in ds.templates[-3:]] == \
        ["topk_join", "range_select", "range_select"]
    seq = traffic.requests(cell.mix, cell.config, ds.templates, 5)
    reqs = [next(seq) for _ in range(32)]
    assert all(0 <= x < 1 and 0 <= y < 1 for x, y in (r.pos for r in reqs))
    plain = dict(cell.mix)
    del plain["pos"]
    again = traffic.requests(plain, cell.config, ds.templates, 5)
    assert [(r.template, r.dist, r.k) for r in reqs] == \
        [(r.template, r.dist, r.k) for r in (next(again) for _ in reqs)]
    keep: dict = {}
    res = harness.run_cell(cell, 5, 3.0, True, "cpu", time.perf_counter(),
                           drain_s=60.0, keep=keep)
    assert res["correct"], res["compared"]
    assert res["metrics"]["serve.admits_per_share_lookup"]["value"] > 0
    ranged = [r for r in keep["window"].program_names
              if r.startswith("serve.")]
    assert "serve.admit" in ranged
    wrong = _with_a_new_shape(tmp_path / "wrong",
                              SHAPE.replace("window(tpl, req, 1.0)",
                                            "window(tpl, req, 0.9)"))
    res = harness.run_cell(wrong, 5, 3.0, False, "cpu", time.perf_counter(),
                           drain_s=60.0)
    assert not res["correct"]
    assert res["compared"]["missed_rows"]["value"] > 0


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
