"""One run of one cell: set-up, the measured window, the comparison.

`run_cell` does what `run.py` is asked for once the card is found: make
the data and traffic from the seed, build the program's store and one
long-lived engine, warm every template up, then drive the engine for the
window from the clients' side (closed loop: a client sends its next request
when its last one completes), and finally hold every answer due in the
window (or a sample drawn from the seed) against the plain reference.

With `trace`, the window runs under the layer timers, the kernel
recorder, the program's own span recorder (`repro_torch.tracing`) and
torch.profiler, and the per-layer metrics are read from them; without it,
nothing but the clients' clocks runs in the window.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import pathlib
import sys
import time

import numpy as np

from . import check, datagen, files, program, traffic

ROOT = pathlib.Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict           # configs/<config>.json
    mix: dict              # traffic/<traffic>.json
    end_to_end: list       # BENCHMARK.json entries this cell reports
    per_layer: list
    root: pathlib.Path = ROOT


def load_cell(name: str, bench: dict | None = None,
              root: pathlib.Path = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json, with its configuration
    and traffic files and the metrics it reports."""
    if bench is None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / cfgs[w["config"]]["file"]).read_text())
    mix = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json")
                     .read_text())
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(name, config, mix, e2e, per_layer, root)


def reader(metric: str, root: pathlib.Path = ROOT):
    """The `read(window)` function of portbench/metrics/<metric>.py."""
    return files.load("metrics", metric, root).read


@dataclasses.dataclass
class Done:
    """One request sent in the window."""
    req: traffic.Request
    sent: float                 # perf_counter at submission
    done: float | None = None   # perf_counter when its answer was seen
    scores: object = None
    rows: object = None
    stats: object = None
    error: object = None


@dataclasses.dataclass
class Window:
    """What a metric reader sees of one run."""
    seconds: float              # the window's length
    setup_s: float
    latencies_ms: list          # of the requests completed in the window
    completed: int
    layer_s: dict | None = None         # traced: self seconds by layer
    serve_steps: int | None = None      # traced: engine steps in the window
    exec_stats: list | None = None      # traced: ExecStats, completed
    launches: dict | None = None        # traced: kernel -> launches
    spans: list | None = None           # traced: device spans in the window
    trace_window_us: tuple | None = None
    bounds: dict | None = None          # traced: kernel -> (bound ms, calls)
    # traced: what `repro_torch.tracing.drain()` gave for the window (int64
    # columns, span names), the window's change of `tracing.COUNTS`, and
    # trace us less perf_counter us (None without a device trace)
    program_spans: dict | None = None
    program_names: list | None = None
    program_counts: dict | None = None
    program_offset_us: float | None = None


class _Tracing:
    """The layer timers, kernel recorder, the program's span recorder and
    the profiler around a window."""

    def __init__(self, device: str):
        from repro_torch import tracing

        from . import bounds, trace
        self.timers = trace.LayerTimers()
        self.recorder = bounds.KernelRecorder()
        self.tracing = tracing
        self.cuda = device == "cuda"
        self.prof = None
        self.offset_us = None

    def start(self, ops) -> None:
        import torch
        self.launch0 = dict(ops.LAUNCHES)
        self.timers.install()
        self.recorder.install()
        if self.cuda:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            # a marker kernel on an idle device ties the trace's clock to
            # the host's: its start is when it was launched
            self.t_marker = time.perf_counter()
            torch.cuda._sleep(100)
            torch.cuda.synchronize()
        self.tracing.drain()
        self.counts0 = dict(self.tracing.COUNTS)
        self.tracing.enable()
        self.t0 = time.perf_counter()

    def stop(self, ops) -> None:
        import torch
        self.t1 = time.perf_counter()
        self.tracing.disable()
        self.counts1 = dict(self.tracing.COUNTS)
        if self.cuda:
            torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
        self.timers.remove()
        self.recorder.remove()
        self.launches = {k: ops.LAUNCHES.get(k, 0) - self.launch0.get(k, 0)
                         for k in ops.LAUNCHES}

    def read(self, w: Window) -> None:
        from . import trace
        w.layer_s = dict(self.timers.self_s)
        w.launches = self.launches
        w.bounds = self.recorder.bounds()
        w.program_spans, w.program_names = self.tracing.drain()
        w.program_counts = {k: v - self.counts0.get(k, 0)
                            for k, v in self.counts1.items()
                            if v != self.counts0.get(k, 0)}
        if self.prof is None:
            return
        spans = trace.device_spans(self.prof.events())
        marker = next((s for s in spans if "spin_kernel" in s[2]),
                      spans[0] if spans else None)
        if marker is None:
            w.spans, w.trace_window_us = [], None
            return
        off = marker[0] - self.t_marker * 1e6     # trace us - host us
        lo, hi = self.t0 * 1e6 + off, self.t1 * 1e6 + off
        w.spans = [(max(a, lo), min(b, hi), name) for a, b, name in spans
                   if b > lo and a < hi and (a, b, name) != marker]
        w.trace_window_us = (lo, hi)
        self.offset_us = w.program_offset_us = off

    def gaps(self, w: Window, n: int = 10) -> list:
        """[layer, seconds] of the n longest device idle gaps, by the layer
        timer that was innermost at the gap's middle."""
        from . import trace
        if not w.trace_window_us:
            return []
        lo, hi = w.trace_window_us
        gaps = sorted(trace.idle_gaps(w.spans, lo, hi),
                      key=lambda g: g[0] - g[1])[:n]
        return [[self.timers.at(((a + b) / 2 - self.offset_us) / 1e6),
                 (b - a) / 1e6] for a, b in gaps]


def _serve(prog, srv, seq, templates, clients: int, seconds: float,
           drain_s: float, on_close) -> tuple[list, float, float]:
    """The closed loop over one serving engine: (requests sent in the
    window, window start, window end)."""
    sent: list = []
    inflight: list = []

    def send():
        r = next(seq)
        req = prog.new_request(len(sent), prog.query(templates[r.template], r))
        d = Done(r, time.perf_counter())
        srv.submit(req)
        sent.append(d)
        inflight.append((req, d))

    t0 = time.perf_counter()
    t_end = t0 + seconds
    for _ in range(clients):
        send()
    closed = False
    while inflight:
        srv.step()
        now = time.perf_counter()
        left = []
        finished = 0
        for req, d in inflight:
            if req.done:
                d.done, d.scores, d.rows = now, req.scores, req.rows
                d.stats, d.error = req.stats, req.error
                finished += 1
            else:
                left.append((req, d))
        inflight = left
        if now < t_end:
            for _ in range(finished):
                send()
        elif not closed:
            closed = True
            on_close()
        if now > t_end + drain_s:
            break                    # what is left never answered
    if not closed:
        on_close()
    return sent, t0, t_end


def _serial(prog, eng, seq, templates, seconds: float, on_close
            ) -> tuple[list, float, float]:
    """One client calling `execute` back to back."""
    sent: list = []
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while time.perf_counter() < t_end:
        r = next(seq)
        q = prog.query(templates[r.template], r)
        d = Done(r, time.perf_counter())
        sent.append(d)
        try:
            d.scores, d.rows, d.stats = eng.execute(q)
        except Exception as exc:     # noqa: BLE001 — a failed request
            d.error = exc
        d.done = time.perf_counter()
    on_close()
    return sent, t0, t_end


def _warm(prog, engine, seq, mix, config, templates, serve: bool,
          limit_s: float = 600.0) -> None:
    """Every template of the mix at the largest distance and k it draws,
    then the traffic's first two blocks, through the window's own engine;
    raises if the serving engine has not answered them in `limit_s`."""
    reqs = traffic.warmup(mix, config, templates)
    reqs += [next(seq) for _ in range(2 * len(mix["templates"]))]
    queries = [prog.query(templates[r.template], r) for r in reqs]
    if not serve:
        for q in queries:
            engine.execute(q)
        return
    warm = [prog.new_request(-1 - i, q) for i, q in enumerate(queries)]
    for req in warm:
        engine.submit(req)
    t_end = time.perf_counter() + limit_s
    while not all(r.done for r in warm):
        if time.perf_counter() > t_end:
            raise RuntimeError("warm-up: the serving engine answered "
                               f"{sum(r.done for r in warm)} of "
                               f"{len(warm)} requests in {limit_s} s")
        engine.step()
    if any(r.error is not None for r in warm):
        raise RuntimeError(f"warm-up: {[r.error for r in warm if r.error]}")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, drain_s: float = 60.0,
             scale: dict | None = None, data_seed: int | None = None,
             keep: dict | None = None) -> dict:
    """One run; returns the result line's object (without `device`'s
    card fields when `device` is not "cuda"). `scale` replaces the
    configuration's generator sizes (the tests' tiny stores), `data_seed`
    its dataset (a check of other datasets); `keep`, where given, gets the
    run's `Window` under "window"."""
    import torch
    cfg, mix = cell.config, cell.mix
    t_build = time.perf_counter()
    if device == "cuda":
        # the kernels' libraries: built on a checkout's first run, loaded
        # on the others; part of set-up, and printed apart
        program.import_port()
        from repro_torch.kernels import _build
        _build.build_all()
    t_build = time.perf_counter() - t_build
    if data_seed is not None:
        cfg = dict(cfg, data_seed=data_seed)
    ds = datagen.make(dict(cfg, scale=scale or cfg["scale"]), seed,
                      cell.root)
    prog = program.Program(ds, cfg, device, cell.root)
    from repro_torch.kernels import ops
    serve = mix["engine"] == "serve"
    engine = (prog.serve_engine(mix["max_slots"]) if serve
              else prog.serial_engine())
    seq = traffic.requests(mix, cfg, ds.templates, seed)
    _warm(prog, engine, seq, mix, cfg, ds.templates, serve)
    if device == "cuda":
        torch.cuda.synchronize()
    tracing = _Tracing(device) if trace else None
    steps0 = engine.stats.steps if serve else None
    # the set-up's objects (the harness's own copy of the data among them)
    # go to the permanent generation: the window's collections walk only
    # what the window allocates
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    if tracing is not None:
        tracing.start(ops)
    closed: dict = {}

    def on_close():
        if tracing is not None:
            tracing.stop(ops)
        if serve:
            closed["steps"] = engine.stats.steps - steps0

    if serve:
        sent, t0, t_end = _serve(prog, engine, seq, ds.templates,
                                 mix["clients"], seconds, drain_s, on_close)
    else:
        sent, t0, t_end = _serial(prog, engine, seq, ds.templates, seconds,
                                  on_close)
    t_drained = time.perf_counter()
    if device == "cuda":
        torch.cuda.synchronize()
    peak = (int(torch.cuda.max_memory_allocated()) if device == "cuda"
            else 0)
    in_window = [d for d in sent if d.done is not None and d.done <= t_end
                 and d.error is None]
    w = Window(seconds=seconds, setup_s=setup_s,
               latencies_ms=[(d.done - d.sent) * 1e3 for d in in_window],
               completed=len(in_window))
    if keep is not None:
        keep["window"] = w
    extra: dict = {}
    breakdown = None
    if tracing is not None:
        from . import trace as trace_mod
        tracing.read(w)
        w.serve_steps = closed.get("steps")
        w.exec_stats = [d.stats for d in in_window]
        if w.trace_window_us:
            lo, hi = w.trace_window_us
            extra = {"busy_s": trace_mod.busy_union_us(w.spans) / 1e6,
                     "window_s": (hi - lo) / 1e6}
            breakdown = {"device_ops": trace_mod.top_ops(w.spans),
                         "idle_gaps": tracing.gaps(w)}
    t_read = time.perf_counter()
    # every answer due in the window (or a sample drawn from the seed),
    # decoded while the program is alive; then its state goes
    unanswered = sum(1 for d in sent if d.done is None or d.error is not None)
    n_check = min(len(sent), int(mix.get("check_sample", len(sent))))
    rng = np.random.default_rng([int(seed), 0xC4EC])
    pick = (sorted(rng.choice(len(sent), size=n_check, replace=False))
            if n_check < len(sent) else range(len(sent)))
    answers = [(sent[i].req, *prog.decode(ds.templates[sent[i].req.template],
                                          sent[i].scores, sent[i].rows))
               for i in pick
               if sent[i].done is not None and sent[i].error is None]
    attempted = len(sent)
    failed = sum(1 for d in sent if d.error is not None)
    del engine, prog, sent, in_window
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_freed = time.perf_counter()
    compared = compare(ds, answers, unanswered, root=cell.root)
    t_checked = time.perf_counter()
    load = " ".join(f"{x:.2f}" for x in os.getloadavg())
    print(f"portbench: kernels built or loaded in {t_build:.3f} s of set-up;"
          f" host workload {host_speed_ms():.1f} ms; load average {load}",
          file=sys.stderr, flush=True)
    print(f"portbench: setup {setup_s:.3f} s, window {t_end - t0:.3f} s, "
          f"drain {t_drained - t_end:.3f} s, trace read "
          f"{t_read - t_drained:.3f} s, decode {t_freed - t_read:.3f} s, "
          f"reference check {t_checked - t_freed:.3f} s "
          f"({len(answers)} answers)", file=sys.stderr, flush=True)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"], cell.root)(w)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": is_correct(compared),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": _device(device, peak, extra)}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = compared
    return out


def groups(ds, items: list, shapes: dict) -> dict:
    """{(template, what its shape reads of the request): [item, ...]} of
    `items`, each a tuple that starts with its request."""
    out: dict = {}
    for item in items:
        r = item[0]
        reads = shapes[ds.templates[r.template].shape].READS
        out.setdefault((r.template,) + tuple(getattr(r, f) for f in reads),
                       []).append(item)
    return out


def compare(ds, answers: list, unanswered: int, ref=None,
            root: pathlib.Path = ROOT) -> dict:
    """The numbers compared, each with its limit, over `answers`:
    (request, scores, keys) triples, each judged by its template's shape
    against one reference answer a group of requests."""
    from . import reference
    ref = ref or reference.Reference(ds)
    shapes = program.shapes_of(ds.templates, root)
    lim = check.limits()
    wrong = missed = 0
    edge = 0.0
    for key, items in groups(ds, answers, shapes).items():
        tpl = ds.templates[key[0]]
        shape = shapes[tpl.shape]
        a = shape.answer(ref, tpl, [r for r, _, _ in items])
        for r, scores, keys in items:
            w_, m_, e_ = shape.judge(a, scores, keys, r, tpl)
            wrong += w_
            missed += m_
            edge = max(edge, e_)
    return {"wrong_rows": {"value": wrong, "limit": lim["wrong_rows"]},
            "missed_rows": {"value": missed, "limit": lim["missed_rows"]},
            "edge_gap": {"value": edge, "limit": lim["edge_gap"]},
            "unanswered": {"value": unanswered, "limit": lim["unanswered"]},
            "checked_requests": {"value": len(answers), "min": 1}}


def is_correct(compared: dict) -> bool:
    """Every number within its limit (at most "limit", at least "min")."""
    return all(v["value"] <= v["limit"] if "limit" in v
               else v["value"] >= v["min"] for v in compared.values())


def host_speed_ms() -> float:
    """The milliseconds of a fixed host workload (pure Python and NumPy):
    how fast the host ran when a run ended, printed beside its numbers."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc += i & 7
    np.sort(np.random.default_rng(0).random(1_000_000))
    return (time.perf_counter() - t0) * 1e3


def _device(device: str, peak: int, extra: dict) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0, **extra}
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": peak, **extra}


def banned_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process, by
    whole top-level name."""
    banned = {"jax", "jaxlib", "flax", "repro"}
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in banned)
