"""Spans around the program's layers, and the device trace's arithmetic.

`LayerTimers` is chip_smoke.py's `timed_layers` (wall timers on the
executor's layer entry points), extended to the serve loop's pooled calls
(`SQuadTree.candidate_nodes`, `node_select.select_batch`, the fused
batcher's flush) and to the two entry points (`SpatialServeEngine.step`,
`StreakEngine.execute`). Time is charged to the innermost open layer, so
each layer's total is its self time: Phase 3 without the refinement it
calls, the serve loop without everything it calls that has a timer.

`device_spans` and `busy_union_us` are chip_smoke.py's functions of the
same names.
"""
from __future__ import annotations

import bisect
import collections
import time

# (layer, module path, owner attribute or None, function): the layer entry
# points, outermost first
TARGETS = (
    ("serve", "repro_torch.serve.spatial", "SpatialServeEngine", "step"),
    ("executor", "repro_torch.core.executor", "StreakEngine", "execute"),
    ("plan", "repro_torch.core.executor", None, "plan_query"),
    ("driver_blocks", "repro_torch.core.executor", "QueryCursor",
     "_materialize"),
    ("sip", "repro_torch.core.shard", None, "sip_select"),
    ("sip", "repro_torch.core.squadtree", "SQuadTree", "candidate_nodes"),
    ("sip", "repro_torch.core.node_select", None, "select_batch"),
    ("driven", "repro_torch.core.aps", None, "choose"),
    ("driven", "repro_torch.core.executor", "StreakEngine", "_driven_nplan"),
    ("driven", "repro_torch.core.executor", "StreakEngine", "_driven_splan"),
    ("phase3", "repro_torch.core.executor", "QueryCursor", "_phase3"),
    ("phase3", "repro_torch.serve.spatial", "_FusedJoinBatcher", "flush"),
    ("refine", "repro_torch.core.executor", "StreakEngine", "_emit_pairs"),
)


class LayerTimers:
    """Self time per layer, and when each layer was innermost.

    `install()` wraps the entry points, `remove()` restores them. `self_s`
    holds seconds by layer; `at(t)` names the layer innermost at
    perf_counter time t ("harness" where none was open)."""

    def __init__(self):
        self.self_s: dict = collections.defaultdict(float)
        self._stack: list = []
        self._mark = 0.0
        self._times: list = []       # perf_counter times of transitions
        self._layers: list = []      # the innermost layer from then on
        self._saved: list = []

    def _enter(self, layer: str) -> None:
        now = time.perf_counter()
        if self._stack:
            self.self_s[self._stack[-1]] += now - self._mark
        self._stack.append(layer)
        self._mark = now
        self._times.append(now)
        self._layers.append(layer)

    def _exit(self) -> None:
        now = time.perf_counter()
        self.self_s[self._stack.pop()] += now - self._mark
        self._mark = now
        self._times.append(now)
        self._layers.append(self._stack[-1] if self._stack else "harness")

    def _wrap(self, fn, layer: str):
        def timed(*args, **kwargs):
            self._enter(layer)
            try:
                return fn(*args, **kwargs)
            finally:
                self._exit()
        return timed

    def install(self) -> None:
        import importlib
        for layer, mod, owner, attr in TARGETS:
            obj = importlib.import_module(mod)
            if owner is not None:
                obj = getattr(obj, owner)
            self._saved.append((obj, attr, getattr(obj, attr)))
            setattr(obj, attr, self._wrap(getattr(obj, attr), layer))

    def remove(self) -> None:
        for obj, attr, fn in reversed(self._saved):
            setattr(obj, attr, fn)
        self._saved = []

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self._times, t) - 1
        return self._layers[i] if i >= 0 else "harness"


def device_spans(events) -> list:
    """(start us, end us, name) of every kernel and copy in a trace's
    events, sorted (chip_smoke.py `device_spans`)."""
    import torch
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)


def busy_union_us(spans) -> float:
    """Microseconds in which the device ran at least one of the spans
    (chip_smoke.py `busy_union_us`)."""
    busy_us, end = 0.0, float("-inf")
    for start, stop, _ in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy_us


def idle_gaps(spans, lo_us: float, hi_us: float) -> list:
    """(start us, end us) of every interval of [lo_us, hi_us] in which no
    span ran."""
    gaps, end = [], lo_us
    for start, stop, _ in spans:
        if start > end:
            gaps.append((end, min(start, hi_us)))
        end = max(end, stop)
        if end >= hi_us:
            break
    if end < hi_us:
        gaps.append((end, hi_us))
    return [(a, b) for a, b in gaps if b > a]


def top_ops(spans, n: int = 10) -> list:
    """[name, seconds] of the n device operations that took most time."""
    by = collections.defaultdict(float)
    for start, stop, name in spans:
        by[name] += (stop - start) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
