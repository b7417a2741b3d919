"""The program's own spans and counters over a benchmark window.

    python3 -m portbench.program_spans --workload lgd.mixed.c8 --seed 7 \
        --seconds 51 [--turns 0] [--out chiprun_out/spans.json]

runs one cell as `--trace 1` does (layer timers, kernel recorder,
torch.profiler) with `repro_torch.tracing`'s recorder on for the window,
and prints one JSON line: the harness's own result, the per-layer metrics
of `METRICS` read from the program's spans and counters, the layer timers'
self ms a query beside the program spans' self ms by the same layers,
share-cache hits and misses by kind, host-to-device bytes by op, and the
ten longest device idle gaps, each with the innermost program span open at
its middle and that span's request id. With `--turns N` it instead times N
windows of `--seconds` with the recorder on and N with it off, in turns on
one long-lived engine and with no profiler, and prints each window's qps.

`ProgramTracing` wraps the harness's `_Tracing` from outside: the harness
does not call it, and `BENCHMARK.json` names none of `METRICS`. Each reader
takes the harness's `Window` with four more attributes, set by
`ProgramTracing.read`: `program_spans` and `program_names` (what
`tracing.drain()` returned), `program_counts` (the window's change of
`tracing.COUNTS`) and `program_offset_us` (trace us less perf_counter us,
None without a device trace).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from unittest import mock

import numpy as np

from . import datagen, harness, program, traffic


class ProgramTracing(harness._Tracing):
    """The harness's tracing, and the program's recorder on for the
    window. The last one made is `ProgramTracing.last`."""
    last = None

    def __init__(self, device: str):
        super().__init__(device)
        program.import_port()
        from repro_torch import tracing
        self.tracing = tracing
        ProgramTracing.last = self

    def start(self, ops) -> None:
        super().start(ops)
        self.tracing.drain()
        self.counts0 = dict(self.tracing.COUNTS)
        self.tracing.enable()

    def stop(self, ops) -> None:
        self.tracing.disable()
        self.counts1 = dict(self.tracing.COUNTS)
        super().stop(ops)

    def read(self, w: harness.Window) -> None:
        super().read(w)
        w.program_spans, w.program_names = self.tracing.drain()
        w.program_counts = {k: v - self.counts0.get(k, 0)
                            for k, v in self.counts1.items()
                            if v != self.counts0.get(k, 0)}
        w.program_offset_us = getattr(self, "offset_us", None)
        self.window = w


# -- readers ---------------------------------------------------------------
def _self_ms(w, name: str) -> float | None:
    """Self ms of the spans `name` in the window, per query completed;
    None where no such span was recorded."""
    spans = getattr(w, "program_spans", None)
    names = getattr(w, "program_names", None) or []
    if spans is None or name not in names or not w.completed:
        return None
    from repro_torch import tracing
    own = spans["name"] == names.index(name)
    if not own.any():
        return None
    return float(tracing.self_ns(spans)[own].sum()) / 1e6 / w.completed


def _counted(w, prefix: str) -> int:
    return sum(v for k, v in (getattr(w, "program_counts", None) or {})
               .items() if k.startswith(prefix))


def cursor_ms(w):
    """Self ms of `exec.cursor` (admission: the plan aside, Bloom
    `prepare`, `cardinality_all`, the root-path probes)."""
    return _self_ms(w, "exec.cursor")


def filter_material_ms(w):
    """Self ms of `exec.filter_material` (V* to SIP intervals)."""
    return _self_ms(w, "exec.filter_material")


def residual_ms(w):
    """Self ms of `serve.step`: the step's time no child span covers."""
    return _self_ms(w, "serve.step")


def prepare_ms(w):
    """Self ms of `phase3.prepare` (driven entities, boxes, key bounds)."""
    return _self_ms(w, "phase3.prepare")


def share_hit_share(w):
    """Share-cache hits over lookups, all kinds, in %."""
    hits, misses = _counted(w, "share.hit:"), _counted(w, "share.miss:")
    return 100.0 * hits / (hits + misses) if hits + misses else None


def h2d_kb(w):
    """KB copied or read in place from host to device a query."""
    b = _counted(w, "h2d.copy:") + _counted(w, "h2d.mapped:")
    return b / 1024 / w.completed if b and w.completed else None


def gc_ms(w):
    """ms of garbage collection (`host.gc` spans) a query."""
    spans = getattr(w, "program_spans", None)
    if spans is None or not len(spans["name"]) or not w.completed:
        return None
    if "host.gc" not in w.program_names:
        return 0.0
    own = spans["name"] == w.program_names.index("host.gc")
    dur = spans["end"][own] - spans["start"][own]
    return float(dur.sum()) / 1e6 / w.completed


def _roots_us(w) -> np.ndarray:
    """(n, 2) trace-clock us of the window's outermost program spans."""
    s = w.program_spans
    root = np.flatnonzero(s["parent"] < 0)
    root = root[np.argsort(s["start"][root], kind="stable")]
    return np.stack([s["start"][root], s["end"][root]], axis=1) / 1e3 \
        + w.program_offset_us


def unspanned_idle_share(w):
    """Device idle time in the window with no program span open, over all
    device idle time, in %."""
    from . import trace
    if (not w.trace_window_us or getattr(w, "program_offset_us", None)
            is None or not len(w.program_spans["name"])):
        return None
    gaps = trace.idle_gaps(w.spans, *w.trace_window_us)
    idle = sum(b - a for a, b in gaps)
    roots = _roots_us(w)
    covered, j = 0.0, 0
    for a, b in gaps:                     # both sorted; roots do not overlap
        while j < len(roots) and roots[j, 1] <= a:
            j += 1
        k = j
        while k < len(roots) and roots[k, 0] < b:
            covered += max(0.0, min(b, roots[k, 1]) - max(a, roots[k, 0]))
            k += 1
    return 100.0 * (idle - covered) / idle if idle > 0 else None


# name: (unit, source, moves, cells, reader): the per-layer metrics the
# program's recorder feeds
BOTH = ["lgd.mixed.c8", "yago3.serial.c1"]
METRICS = {
    "exec.cursor_ms_per_query": ("ms", "program_span", "latency_p50_ms",
                                 BOTH, cursor_ms),
    "exec.filter_material_ms_per_query": ("ms", "program_span",
                                          "latency_p50_ms", BOTH,
                                          filter_material_ms),
    "serve.residual_ms_per_query": ("ms", "program_span", "qps",
                                    ["lgd.mixed.c8"], residual_ms),
    "phase3.prepare_ms_per_query": ("ms", "program_span", "latency_p50_ms",
                                    BOTH, prepare_ms),
    "exec.share_hit_share": ("%", "program_counter", "qps",
                             ["lgd.mixed.c8"], share_hit_share),
    "kernels.h2d_kb_per_query": ("KB", "program_counter", "latency_p50_ms",
                                 BOTH, h2d_kb),
    "host.gc_ms_per_query": ("ms", "program_span", "latency_p95_ms", BOTH,
                             gc_ms),
    "host.unspanned_idle_share": ("%", "device_trace", "qps", BOTH,
                                  unspanned_idle_share),
}

# the layer timers' layers (portbench/trace.py) by the program spans that
# open them; a span not named here belongs to its parent's layer
LAYER_OF_SPAN = {
    "serve.step": "serve", "exec.execute": "executor", "exec.plan": "plan",
    "exec.materialize": "driver_blocks", "sip.select": "sip",
    "sip.descend": "sip", "sip.node_select": "sip", "driven.aps": "driven",
    "driven.nplan": "driven", "driven.splan": "driven",
    "phase3.prepare": "phase3", "phase3.join": "phase3",
    "phase3.flush": "phase3", "refine.emit": "refine",
    "refine.exact": "refine"}
# the six layer-timer metrics, by their layer
TIMER_METRICS = {"serve": "serve.self_ms_per_query",
                 "driver_blocks": "exec.materialize_ms_per_query",
                 "sip": "sip.ms_per_query", "driven": "driven.ms_per_query",
                 "phase3": "phase3.ms_per_query",
                 "refine": "refine.ms_per_query"}


def layer_self_ms(spans: dict, names: list) -> dict:
    """{layer timer's layer: self ms} of program spans: each span's self
    time charged to the layer of its nearest span that `LAYER_OF_SPAN`
    names ("harness" for spans outside every such span)."""
    from repro_torch import tracing
    own = tracing.self_ns(spans)
    named = [LAYER_OF_SPAN.get(n) for n in names]
    layer: list = []
    out: dict = {}
    for i, (nid, parent) in enumerate(zip(spans["name"].tolist(),
                                          spans["parent"].tolist())):
        lay = named[nid] or (layer[parent] if parent >= 0 else "harness")
        layer.append(lay)
        out[lay] = out.get(lay, 0.0) + own[i] / 1e6
    return out


def span_self_ms(w) -> dict:
    """{span name: self ms a query} of the window, largest first."""
    spans = w.program_spans
    if not len(spans["name"]) or not w.completed:
        return {}
    from repro_torch import tracing
    by = np.bincount(spans["name"], weights=tracing.self_ns(spans),
                     minlength=len(w.program_names)) / 1e6 / w.completed
    return {w.program_names[i]: float(by[i]) for i in np.argsort(-by)
            if by[i] > 0}


def layer_agreement(w) -> dict:
    """{layer: [layer timers' self ms a query, program spans' self ms a
    query]} of the six layer-timer layers."""
    if not w.layer_s or not w.completed:
        return {}
    mine = layer_self_ms(w.program_spans, w.program_names)
    return {lay: [w.layer_s.get(lay, 0.0) * 1e3 / w.completed,
                  mine.get(lay, 0.0) / w.completed]
            for lay in TIMER_METRICS}


def gaps(w, n: int = 10) -> list:
    """[innermost program span, its request id, seconds] of the n longest
    device idle gaps in the window, at each gap's middle ("none" where no
    span was open)."""
    from . import trace
    if not w.trace_window_us or getattr(w, "program_offset_us", None) is None:
        return []
    s, names = w.program_spans, w.program_names
    start = s["start"] / 1e3 + w.program_offset_us
    end = s["end"] / 1e3 + w.program_offset_us
    out = []
    for a, b in sorted(trace.idle_gaps(w.spans, *w.trace_window_us),
                       key=lambda g: g[0] - g[1])[:n]:
        t = (a + b) / 2
        open_ = np.flatnonzero((start <= t) & (end > t))
        if len(open_):
            i = open_[np.argmax(start[open_])]
            out.append([names[s["name"][i]], int(s["rid"][i]), (b - a) / 1e6])
        else:
            out.append(["none", -1, (b - a) / 1e6])
    return out


def h2d_rate_gb_s(w) -> float | None:
    """The window's counted `h2d.copy` bytes over the trace's host-to-device
    memcpy time, in GB/s: above the bus's 64 GB/s, the counter over-counts."""
    if not w.spans:
        return None
    us = sum(b - a for a, b, name in w.spans if "HtoD" in name)
    copied = _counted(w, "h2d.copy:")
    return copied / (us * 1e3) if us > 0 else None


def report(w) -> dict:
    """Everything the program's spans and counters say of one window."""
    counts = getattr(w, "program_counts", {}) or {}
    metrics = {}
    for name, (unit, *_, read) in METRICS.items():
        value = read(w)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    return {"metrics": metrics,
            "self_ms_per_query": span_self_ms(w),
            "layers_ms_per_query": layer_agreement(w),
            "share": {k: v for k, v in sorted(counts.items())
                      if k.startswith("share.")},
            "h2d_bytes": {k: v for k, v in sorted(counts.items())
                          if k.startswith("h2d.")},
            "h2d_copy_gb_s": h2d_rate_gb_s(w),
            "idle_gaps": gaps(w),
            "spans": int(len(w.program_spans["name"])),
            "completed": w.completed}


def traced_run(cell: harness.Cell, seed: int, seconds: float, device: str,
               t_start: float, **kw) -> tuple[dict, dict]:
    """(the harness's result line, `report`) of one traced run."""
    with mock.patch.object(harness, "_Tracing", ProgramTracing):
        res = harness.run_cell(cell, seed, seconds, True, device, t_start,
                               **kw)
    return res, report(ProgramTracing.last.window)


def cost_turns(cell: harness.Cell, seed: int, seconds: float, turns: int,
               device: str, scale: dict | None = None) -> list:
    """[[recorder on, qps, spans recorded], ...]: windows of `seconds`
    with the recorder off and on in turns (off, on, on, off, ...), on one
    store and one engine warmed as the harness warms them."""
    program.import_port()
    from repro_torch import tracing
    cfg, mix = cell.config, cell.mix
    ds = datagen.make(dict(cfg, scale=scale or cfg["scale"]), seed)
    prog = program.Program(ds, cfg, device)
    serve = mix["engine"] == "serve"
    engine = (prog.serve_engine(mix["max_slots"]) if serve
              else prog.serial_engine())
    seq = traffic.requests(mix, cfg, ds.templates, seed)
    harness._warm(prog, engine, seq, mix, cfg, ds.templates, serve)
    out = []
    for i in range(2 * turns):
        on = i % 4 in (1, 2)
        gc.collect()
        gc.freeze()
        tracing.drain()
        if on:
            tracing.enable()
        if serve:
            sent, _, t_end = harness._serve(
                prog, engine, seq, ds.templates, mix["clients"], seconds,
                60.0, tracing.disable)
        else:
            sent, _, t_end = harness._serial(prog, engine, seq,
                                             ds.templates, seconds,
                                             tracing.disable)
        done = sum(1 for d in sent if d.done is not None
                   and d.done <= t_end and d.error is None)
        out.append([on, done / seconds, int(len(tracing.drain()[0]["name"]))])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--turns", type=int, default=0)
    ap.add_argument("--out", default=None, help="also append the line here")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    from . import run
    os.environ.update(run.ENV)
    import torch
    if not torch.cuda.is_available():
        print("portbench.program_spans: needs a CUDA device", file=sys.stderr)
        return 2
    program.import_port()
    from repro_torch.kernels import _build
    _build.build_all()
    cell = harness.load_cell(args.workload)
    if args.turns:
        line = {"workload": args.workload, "seed": args.seed,
                "turns": cost_turns(cell, args.seed, args.seconds,
                                    args.turns, "cuda")}
    else:
        res, rep = traced_run(cell, args.seed, args.seconds, "cuda", t_start)
        line = {"workload": args.workload, "seed": args.seed,
                "correct": res["correct"], "harness": res, "program": rep}
    line["device"] = torch.cuda.get_device_name(0)
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
