"""The Geographica map deployment (`geo.maps.c8`) at a tiny scale: the
cell is correct; a program that answers each selection over a window or
d a tenth smaller is not, nor is the `dist` control; every centre is a
looked-up place."""
import collections
import json
import math
import pathlib
import shutil
import time

import numpy as np
import pytest

from portbench import control, datagen, files, harness, reference, traffic

ROOT = pathlib.Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
TINY = {"n_per_class": 300}
SEED = 3000000017


def _cell(root: pathlib.Path = ROOT) -> harness.Cell:
    cell = harness.load_cell("geo.maps.c8", root=root)
    cell.config["store"]["block"] = 128
    return cell


def _run(cell: harness.Cell, trace: bool = False, keep=None) -> dict:
    return harness.run_cell(cell, SEED, 3.0, trace, "cpu",
                            time.perf_counter(), drain_s=60.0, scale=TINY,
                            keep=keep)


def test_the_cell_is_correct_and_reads_its_metrics():
    keep: dict = {}
    res = _run(_cell(), trace=True, keep=keep)
    assert res["correct"], res["compared"]
    assert res["compared"]["edge_gap"]["value"] == 0.0
    assert res["compared"]["checked_requests"]["value"] == 240
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mine = [m["name"] for m in bench["per_layer"]
            if "geo.maps.c8" in m["workloads"]]
    assert sorted(res["metrics"]) == sorted(mine)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert 0 < got["shape.kept_share"] < 100
    assert got["shape.ms_per_query"] > got["shape.exact_ms_per_query"] > 0
    assert got["shape.ms_per_query"] > got["shape.sip_ms_per_query"] > 0
    counts = keep["window"].program_counts
    assert {k.split(":")[1] for k in counts if k.startswith("shape.")} == \
        {"range", "within"}


# each shape's query, a tenth smaller: a program that answers less
SMALLER = {"range_select": ("window=window(tpl, req)",
                            "window=_smaller(window(tpl, req))",
                            "\n\ndef _smaller(w):\n"
                            "    h = 0.05 * (w[2] - w[0])\n"
                            "    return (w[0] + h, w[1] + h, w[2] - h, "
                            "w[3] - h)\n"),
           "within_point": ("dist=float(req.dist),",
                            "dist=0.9 * float(req.dist),", "")}


@pytest.mark.parametrize("shape", sorted(SMALLER))
def test_a_tenth_smaller_is_not_correct(tmp_path, shape):
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    path = tmp_path / "portbench" / "shapes" / f"{shape}.py"
    old, new, helper = SMALLER[shape]
    text = path.read_text()
    assert text.count(old) == 1
    path.write_text(text.replace(old, new) + helper)
    res = _run(_cell(tmp_path))
    assert not res["correct"]
    assert res["compared"]["missed_rows"]["value"] > 0


def test_the_dist_control_is_not_correct():
    got = control.readings(_cell(), SEED, 240, TINY, kind="dist")
    assert not harness.is_correct(got)
    assert got["edge_gap"]["value"] > got["edge_gap"]["limit"]


def test_centres_are_looked_up_places():
    """The six templates share 4,096 anchors, stored points of hotels,
    pubs and police stations; every request is centred on one (a device
    0.5 d from one); an answer over the anchor's own class holds rows, and
    every template answers some requests with rows."""
    cell = _cell()
    cfg = dict(cell.config, scale=TINY)
    ds = datagen.make(cfg, SEED, cell.root)
    sel = ds.templates[8:]
    assert [t.shape for t in sel] == ["range_select"] * 4 + \
        ["within_point"] * 2
    assert all(t.anchors is sel[0].anchors for t in sel)
    assert len(sel[0].anchors) == 4096
    classes = collections.defaultdict(set)   # stored point -> its classes
    for e, g in ds.exact.items():
        cls = ds.terms[e - 1].partition("/e")[0]
        for pt in np.asarray(g, np.float32).astype(np.float64):
            classes[tuple(pt)].add(cls)
    looked_up = {"class:hotel", "class:pub", "class:police"}
    assert all(classes[a] & looked_up for a in sel[0].anchors)
    assert set().union(*(classes[a] for a in sel[0].anchors)) >= looked_up
    ref = reference.Reference(ds)
    window = files.load("shapes", "range_select", cell.root)
    within = files.load("shapes", "within_point", cell.root)
    seq = traffic.requests(cell.mix, cfg, ds.templates, SEED)
    reqs = [next(seq) for _ in range(600)]
    assert {r.template for r in reqs} == set(range(8, 14))
    held = collections.Counter()
    for r in reqs:
        tpl = ds.templates[r.template]
        assert r.dist == tpl.dist
        c = window.centre(tpl, r)
        assert c in classes
        if tpl.shape == "within_point":
            p = within.point(tpl, r)
            assert math.isclose(math.dist(p, c), 0.5 * r.dist)
            scores, keys = within.served(ref, tpl, [r])[0]
            assert (scores <= r.dist).all()
        else:
            scores, keys = window.served(ref, tpl, [r])[0]
        if ds.terms[tpl.patterns[0][3] - 1] in classes[c]:
            assert len(keys) > 0
        held[r.template] += len(keys) > 0
    assert all(held[t] > 0 for t in range(8, 14)), held
