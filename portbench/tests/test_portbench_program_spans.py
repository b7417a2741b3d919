"""The program's own spans and counters over a benchmark window
(`portbench/program_spans.py`), at a tiny scale on the CPU: the metrics a
CPU run can read, the layer timers' six layers against the program spans'
self times, and an untraced run leaves the recorder untouched."""
import time

import pytest

from portbench import harness, program_spans
from portbench.tests.test_portbench_cells import SCALES, SEED, run, tiny

CELLS = ("lgd.mixed.c8", "yago3.serial.c1")
# read from a CPU run: spans and the share counters (host-to-device bytes
# and the device's idle time need the card)
ON_CPU = {"exec.cursor_ms_per_query", "exec.filter_material_ms_per_query",
          "serve.residual_ms_per_query", "phase3.prepare_ms_per_query",
          "exec.share_hit_share", "host.gc_ms_per_query"}


@pytest.fixture(scope="module", params=CELLS)
def traced(request):
    cell = tiny(request.param)
    res, rep = program_spans.traced_run(
        cell, SEED, 12.0, "cpu", time.perf_counter(), drain_s=60.0,
        scale=SCALES[cell.config["name"]])
    return request.param, res, rep


def test_traced_run_reads_the_cpu_readable_metrics(traced):
    name, res, rep = traced
    assert res["correct"], res["compared"]
    want = {m for m in ON_CPU if name in program_spans.METRICS[m][3]}
    got = rep["metrics"]
    assert set(got) == want
    for m in want - {"host.gc_ms_per_query"}:
        assert got[m]["value"] > 0, m
    assert got["host.gc_ms_per_query"]["value"] >= 0
    assert rep["h2d_bytes"] == {} and rep["idle_gaps"] == []
    if name == "lgd.mixed.c8":
        assert rep["share"]["share.hit:mat"] > 0
    else:
        assert rep["share"] == {}


def test_layer_timers_agree_with_program_spans(traced):
    """Each of the six layer-timer layers' self time equals the summed
    self time of the program spans that map to it, within 5% or 0.5 ms a
    query."""
    name, res, rep = traced
    layers = rep["layers_ms_per_query"]
    assert set(layers) == set(program_spans.TIMER_METRICS)
    for layer, (timers, spans) in layers.items():
        assert abs(timers - spans) <= max(0.05 * timers, 0.5), \
            (layer, timers, spans)
    # the readers of the timers' metrics read the same numbers
    for layer, metric in program_spans.TIMER_METRICS.items():
        if metric in res["metrics"]:
            assert res["metrics"][metric]["value"] == \
                pytest.approx(layers[layer][0])


def test_untraced_run_leaves_the_recorder_empty():
    from repro_torch import tracing
    tracing.drain()
    res = run("lgd.mixed.c8", trace=False, seconds=2.0)
    assert res["correct"]
    spans, _ = tracing.drain()
    assert len(spans["name"]) == 0


def test_every_metric_names_cells_and_metrics_of_the_benchmark():
    import json
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    taken = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    for name, (unit, source, moves, workloads, read) in \
            program_spans.METRICS.items():
        assert name not in taken
        assert set(workloads) <= cells and moves in e2e, name
        assert source in ("program_span", "program_counter", "device_trace")
        assert callable(read) and unit
